"""Multi-process bring-up for the (gop, tile) mesh (counterpart of
cairo_tpu/tpu/cluster.py), on torch.distributed.

One process per host; each contributes its local devices to the global
mesh, in process-major order, as jax.devices() lists them, so
shard.make_mesh places GOP rows and tiles as the JAX package does. The
codec needs no parameter synchronization: the only traffic between
processes is the per-frame halo exchange of a GOP row that spans them
(shard.halo_exchange) and the gather of that row's slice payloads
(tiled._allgather_payloads), so GOP rows place naturally one per process.
The process group's backend follows the devices: NCCL for CUDA devices,
gloo for CPU ones.

    from cairo_tpu_torch.gpu import cluster, tiled
    spec = cluster.initialize(coordinator="host0:1234", num_processes=2,
                              process_id=RANK)
    enc = tiled.TiledEncoder(n_tiles=spec.tiles_per_gop,
                             n_gops=spec.n_gops, devices=spec.devices)
    # every process passes the frames of every GOP to encode_batch and
    # keeps the streams of its own GOP rows
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    n_gops: int
    tiles_per_gop: int
    process_id: int
    # the global devices, process-major: (process rank, device) pairs, as
    # shard.make_mesh takes them
    devices: tuple = ()


def initialize(coordinator: str | None = None, num_processes: int = 1,
               process_id: int = 0, tiles_per_gop: int | None = None,
               allow_cross_host_tiles: bool = False,
               devices=None) -> MeshSpec:
    """Initializes torch.distributed (nothing for a single process) and
    returns the (gop, tile) mesh: GOP rows = processes, tile columns = a
    process's devices (`devices`, by default its CUDA devices; the CPU
    tests pass ["cpu"] * k). `coordinator` is "host:port" of process 0.

    allow_cross_host_tiles=True lets one GOP's tile axis span processes:
    the per-frame halo exchange then crosses them and the slice payloads
    are gathered (tiled.TiledEncoder.encode_batch). Viable, just not the
    default."""
    local = [str(d) for d in (devices if devices is not None else
             [f"cuda:{i}" for i in range(torch.cuda.device_count())])]
    if not local:
        raise ValueError("no local devices: this process has no CUDA "
                         "device; pass devices=['cpu'] to run on the CPU")
    kinds = {torch.device(d).type for d in local}
    if len(kinds) > 1:
        raise ValueError("a process's devices must be all CUDA or all CPU")
    gathered = [local]
    if num_processes > 1:
        if kinds == {"cuda"}:
            backend = "nccl"
            torch.cuda.set_device(torch.device(local[0]))
        else:
            backend = "gloo"
        address = coordinator if "://" in coordinator \
            else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=address,
                                world_size=num_processes, rank=process_id)
        gathered = [None] * num_processes
        dist.all_gather_object(gathered, local)
    if tiles_per_gop is None:
        tiles_per_gop = len(local)
    if tiles_per_gop > len(local) and not allow_cross_host_tiles:
        raise ValueError("a GOP's tiles must stay on one host's devices "
                         "(the halo exchange stays inside the process); "
                         "pass allow_cross_host_tiles=True to override")
    everywhere = tuple((p, d) for p, devs in enumerate(gathered)
                       for d in devs)
    return MeshSpec(n_gops=len(everywhere) // tiles_per_gop,
                    tiles_per_gop=tiles_per_gop, process_id=process_id,
                    devices=everywhere)
