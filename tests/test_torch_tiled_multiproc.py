"""The tiled encoder across two processes on the CPU (gloo), against the
same encoder in one process: byte-identical streams.

    python tests/test_torch_tiled_multiproc.py CASE RANK PORT OUT

runs one worker process (it imports only cairo_tpu_torch): it joins a
2-process group on localhost:PORT with cluster.initialize, encodes 3
frames of 2 GOPs (case "rows": one GOP row of 2 CPU tiles per process) or
of 1 GOP whose 2 tiles live one in each process (case "cross":
allow_cross_host_tiles, so the halo crosses the processes by
batch_isend_irecv and the payloads are gathered), and writes its chunks
to OUT. Each worker gets a hard timeout, so nothing can hang the suite.
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
CASES = {
    # case: (local devices per process, tiles_per_gop, cross-host tiles)
    "rows": (["cpu", "cpu"], 2, False),
    "cross": (["cpu"], 2, True),
}
SIZE = (64, 48)


def _frames(n_gops):
    from cairo_tpu_torch.synth import synth_frames
    return [synth_frames(*SIZE, 3, seed=11 + g) for g in range(n_gops)]


def _encode(enc, n_gops):
    enc.set_quality(14)
    return [enc.encode_batch(list(batch)) for batch in zip(*_frames(n_gops))]


def worker(case, rank, port, out):
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from cairo_tpu_torch.gpu import cluster, tiled

    devices, tiles, cross = CASES[case]
    spec = cluster.initialize(coordinator=f"localhost:{port}",
                              num_processes=2, process_id=rank,
                              tiles_per_gop=tiles,
                              allow_cross_host_tiles=cross, devices=devices)
    enc = tiled.TiledEncoder(n_tiles=spec.tiles_per_gop,
                             n_gops=spec.n_gops, devices=spec.devices)
    chunks = _encode(enc, spec.n_gops)
    with open(out, "wb") as fh:
        pickle.dump(dict(n_gops=spec.n_gops, chunks=chunks), fh)
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(case, tmp_path):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(rank), str(port),
         str(tmp_path / f"{rank}.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"worker {rank}:\n{logs[rank]}"
    results = []
    for rank in range(2):
        with open(tmp_path / f"{rank}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results


def _single_process(n_gops):
    from cairo_tpu_torch.gpu import tiled
    enc = tiled.TiledEncoder(n_tiles=2, n_gops=n_gops,
                             devices=["cpu"] * (2 * n_gops))
    return _encode(enc, n_gops)


def test_gop_rows_one_per_process(tmp_path):
    """Default placement: process r owns GOP row r and returns its
    stream, None for the other's."""
    results = _run_workers("rows", tmp_path)
    want = _single_process(2)
    for rank, res in enumerate(results):
        assert res["n_gops"] == 2
        for i, (got, exp) in enumerate(zip(res["chunks"], want)):
            assert got[rank] == exp[rank], f"rank {rank} frame {i}"
            assert got[1 - rank] is None


def test_tiles_across_processes(tmp_path):
    """One GOP, one tile per process: the halo crosses the processes and
    every process returns the whole stream."""
    results = _run_workers("cross", tmp_path)
    want = _single_process(1)
    for rank, res in enumerate(results):
        assert res["n_gops"] == 1
        assert res["chunks"] == want, f"rank {rank}"


def test_initialize_single_process():
    """One process: no process group; tiles stay on its devices unless
    cross-host tiles are allowed, as cluster.py:37-64 has it."""
    import pytest

    from cairo_tpu_torch.gpu import cluster, shard

    spec = cluster.initialize(devices=["cpu"] * 4, tiles_per_gop=2)
    assert (spec.n_gops, spec.tiles_per_gop, spec.process_id) == (2, 2, 0)
    mesh = shard.make_mesh(spec.n_gops, spec.tiles_per_gop, spec.devices)
    assert mesh.local_keys() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert not mesh.rows_split()
    with pytest.raises(ValueError):
        cluster.initialize(devices=["cpu"], tiles_per_gop=2)
    with pytest.raises(ValueError):
        cluster.initialize(devices=["cpu", "meta"])


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
