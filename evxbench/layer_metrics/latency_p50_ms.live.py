"""The median due-to-chunk ms over the frames due in the window before the
traced stretch, beside the tail that encode_p95_ms reports."""

from harness import stats


def read(run):
    lat, _ = run.latencies()
    return 1e3 * stats.percentile(lat, 50) if lat else None
