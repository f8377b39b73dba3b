"""Host-device copy bytes a frame, in MB (1e6 bytes): the program's
`bytes.upload` and `bytes.download` counters (each upload's packed bytes
and each download's tensors, counted where gpu/pipeline.py `DeviceQueue`
issues them), summed over every session's frames whose upload was counted
in the window before the traced stretch, over those frames."""

from harness import spanlog


def read(run):
    logs = spanlog.logs(run)
    if logs is None:
        return None
    total, frames = 0, 0
    for log in logs:
        counts = log.counts("bytes.upload", "bytes.download")
        mine = {c.frame for c in counts
                if c.name == "bytes.upload" and run.untraced(c.at)}
        total += sum(c.value for c in counts if c.frame in mine)
        frames += len(mine)
    return total / 1e6 / frames if frames else None
