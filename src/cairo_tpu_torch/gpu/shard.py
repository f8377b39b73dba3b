"""Frames split into tiles across devices, GOPs across rows of them
(counterpart of cairo_tpu/tpu/shard.py; docs/SHARDING.md).

The mesh is a (n_gops, n_tiles) grid of torch devices: independent GOPs
down the rows, each frame's macroblock columns split across a row. A
device may appear more than once, so several tiles can share one card.
Every tile keeps its ring reconstruction with a HALO-column margin of its
neighbours' deblocked pixels (CHALO in chroma), refreshed once a frame by
the halo exchange, so that motion search and prediction reach across tile
edges; deblocking is tile-local.

A tile's step is the single-card step's pieces (gpu/engine.py) run on its
columns with the ring halo: JAX's _classify_tile is
engine._classify_inter and its _pred_for_tile engine._gather_pred, both at
halo=HALO with the tile's origin x0 and the aligned frame width; K1-K4
read the halo in place. The steps stop before the ring write, which waits
for the exchange (halo_exchange, then engine.write_slot).

Each tile in this process runs on a DeviceQueue of its own (gpu/
pipeline.py), so tiles on one card or on several issue to separate
compute streams. The exchange copies a neighbour's deblocked strip after
that neighbour's event on its stream: on one device a copy on the
receiving tile's stream, across devices a peer copy between the two
streams. Between processes the strips travel by
torch.distributed.batch_isend_irecv: gloo with CPU tensors, NCCL with
CUDA tensors (this one waits on the host for the strips it sends).
Frame-edge tiles take zeros, as ppermute gives them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .. import tables
from . import engine, ops
from .pipeline import DeviceQueue

RING = tables.REFERENCE_FRAME_COUNT
HALO = 32            # Y halo columns (search reach 16 + sub-pel + margin)
CHALO = HALO // 2
HALOS = (HALO, CHALO, CHALO)
STATE_KEYS = ("ring_y", "ring_u", "ring_v", "coef_y", "coef_u", "coef_v")
I32 = torch.int32


def init_tile_state(tile_w: int, aligned_h: int, device) -> dict:
    """One tile's codec state, zeroed; the ring planes carry the halo
    columns (shard.py:32-43). A tile narrower than HALO has no strips of
    the halo's width to give its neighbours, and raises (so do JAX's
    shapes)."""
    if tile_w < HALO:
        raise ValueError(f"tiles must be at least {HALO} pixels wide, got "
                         f"{tile_w}")

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int16, device=device)

    return dict(ring_y=z(RING, aligned_h, tile_w + 2 * HALO),
                ring_u=z(RING, aligned_h // 2, tile_w // 2 + 2 * CHALO),
                ring_v=z(RING, aligned_h // 2, tile_w // 2 + 2 * CHALO),
                coef_y=z(aligned_h, tile_w),
                coef_u=z(aligned_h // 2, tile_w // 2),
                coef_v=z(aligned_h // 2, tile_w // 2))


def tile_state_from_numpy(arrays, mesh) -> dict:
    """{(g, t): state} for this process's tiles from the (n_gops, n_tiles,
    ...) arrays of a JAX TiledEncoder's _state (as numpy), each on its
    tile's device."""
    return {key: {k: torch.from_numpy(np.array(arrays[k][key], np.int16))
                  .to(mesh.device(key)) for k in STATE_KEYS}
            for key in mesh.local_keys()}


# ------------------------------------------------------------------ mesh

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (n_gops, n_tiles) grid: each cell's device and the rank of the
    process that owns it; `rank` is this process's."""
    devices: tuple
    owners: tuple
    rank: int = 0

    @property
    def shape(self):
        return len(self.devices), len(self.devices[0])

    def device(self, key) -> torch.device:
        return self.devices[key[0]][key[1]]

    def owner(self, key) -> int:
        return self.owners[key[0]][key[1]]

    def is_local(self, key) -> bool:
        return self.owner(key) == self.rank

    def local_keys(self) -> list:
        n_gops, n_tiles = self.shape
        return [(g, t) for g in range(n_gops) for t in range(n_tiles)
                if self.is_local((g, t))]

    def rows_split(self) -> bool:
        """Whether some GOP row's tiles live in more than one process (a
        global, static property: every process enters the payload gather
        together)."""
        return any(len(set(row)) > 1 for row in self.owners)


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def make_mesh(n_gop: int, n_tile: int, devices=None) -> Mesh:
    """The (gop, tile) grid over `devices`, GOP rows first, as JAX's
    make_mesh reshapes jax.devices() (shard.py:324-327). An entry is a
    device of this process ("cuda:0", "cpu", a torch.device) or a
    (process rank, device) pair (cluster.MeshSpec.devices, the global
    process-major order). Repeats are allowed. The default is this
    process's CUDA devices; fewer devices than the grid has cells
    raise."""
    from .api import resolve_device

    rank = _rank()
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    need = n_gop * n_tile
    if len(devices) < need:
        raise ValueError(
            f"a ({n_gop}, {n_tile}) (gop, tile) mesh needs {need} devices, "
            f"{len(devices)} given (pass devices=['cpu'] * {need} to run "
            f"on the CPU, or ['cuda:0'] * {need} to share one card)")
    cells = []
    for d in devices[:need]:
        owner, dev = d if isinstance(d, tuple) else (rank, d)
        cells.append((owner, resolve_device(dev) if owner == rank
                      else torch.device(dev)))
    if len({d.type for _, d in cells}) > 1:
        raise ValueError("a mesh's devices must be all CUDA or all CPU")
    rows = [cells[g * n_tile:(g + 1) * n_tile] for g in range(n_gop)]
    return Mesh(devices=tuple(tuple(d for _, d in r) for r in rows),
                owners=tuple(tuple(o for o, _ in r) for r in rows),
                rank=rank)


# ------------------------------------------------------------------ steps

def _scalar(v, device):
    return torch.tensor(v, dtype=I32, device=device)


def tile_encode_step(rgb_tile, state, frame_index, quality, *, tile_w,
                     aligned_h, full_width, is_inter, x0, frame_w=None,
                     frame_h=None):
    """One frame for one tile (shard.py:119-251) up to its deblocked
    reconstruction. rgb_tile: (aligned_h, tile_w, 3) uint8 on the state's
    device; x0: the tile's first column in the frame; frame_w/frame_h:
    the real frame dims, beyond which the converted pixels are zeroed as
    the single-card wire's are, so a 1-tile stream equals GpuEncoder's.
    Returns (outputs, (rec_y, rec_u, rec_v)): the tile's block table and
    coefficient planes (the state's, updated) and its deblocked core
    planes, which halo_exchange widens into the ring slot."""
    dev = rgb_tile.device
    y_in, u_in, v_in = ops.rgb_to_yuv420(rgb_tile)
    if frame_w is not None or frame_h is not None:
        fw = full_width if frame_w is None else frame_w
        fh = aligned_h if frame_h is None else frame_h
        cols = x0 + torch.arange(tile_w, device=dev)
        rows = torch.arange(aligned_h, device=dev)
        ymask = (rows[:, None] < fh) & (cols[None, :] < fw)
        cmask = ymask[::2, ::2]
        y_in = torch.where(ymask, y_in, 0)
        u_in = torch.where(cmask, u_in, 0)
        v_in = torch.where(cmask, v_in, 0)
    outputs, rec, _ = engine.encode_planes(
        y_in, u_in, v_in, state, _scalar(frame_index, dev),
        _scalar(quality, dev), is_inter=is_inter, x0=x0,
        full_width=full_width, halo=HALO)
    return outputs, rec


def tile_decode_step(table, coef, state, frame_index):
    """One frame's reconstruction for one tile (shard.py:254-321, fast
    streams: no intra-motion blocks) up to its deblocked core planes;
    table/coef: dicts of the tile's block-table fields and coefficient
    planes on the state's device. The prediction is zeroed where
    is_intra & ~is_motion, as engine.decode_planes does."""
    dev = state["ring_y"].device
    return engine.decode_planes(
        table, coef["coef_y"].to(I32), coef["coef_u"].to(I32),
        coef["coef_v"].to(I32), state, _scalar(frame_index, dev),
        halo=HALO)


# ---------------------------------------------------------- halo exchange

def _tag(mesh, g, t, p, leftward):
    """One transfer's tag, the same at both ends: boundary (g, t | t+1),
    plane p, direction."""
    return ((g * mesh.shape[1] + t) * 3 + p) * 2 + int(leftward)


def _remote_strips(mesh, queues, cores):
    """The strips that cross processes, sent and received in one
    batch_isend_irecv; returns {(key, side, plane): received strip} on
    the receiving tile's device, ordered before its compute stream."""
    n_gops, n_tiles = mesh.shape
    sends, recvs, ops_ = [], {}, []
    for g in range(n_gops):
        for t in range(n_tiles - 1):
            a, b = (g, t), (g, t + 1)
            if mesh.is_local(a) == mesh.is_local(b):
                continue
            for p, halo in enumerate(HALOS):
                # a's right strip becomes b's left margin, and b's left
                # strip a's right margin, in this order at both ends
                for src, dst, cols, side, leftward in (
                        (a, b, slice(-halo, None), "left", False),
                        (b, a, slice(0, halo), "right", True)):
                    tag = _tag(mesh, g, t, p, leftward)
                    if mesh.is_local(src):
                        q = queues[src]
                        with q.steps():
                            strip = cores[src][p][:, cols].to(
                                torch.int16).contiguous()
                        sends.append((src, strip))
                        ops_.append(dist.P2POp(dist.isend, strip,
                                               mesh.owner(dst), tag=tag))
                    else:
                        h = cores[dst][p].shape[0]
                        buf = torch.empty((h, halo), dtype=torch.int16,
                                          device=mesh.device(dst))
                        recvs[(dst, side, p)] = buf
                        ops_.append(dist.P2POp(dist.irecv, buf,
                                               mesh.owner(src), tag=tag))
    if not ops_:
        return {}
    # a CUDA strip is sent from the device's current stream, which the
    # tile's compute stream does not order: wait for the strips on the host
    for src, _ in sends:
        if queues[src].cuda:
            queues[src].mark().synchronize()
    for work in dist.batch_isend_irecv(ops_):
        work.wait()
    for (dst, _, _), buf in recvs.items():
        q = queues[dst]
        if q.cuda:
            # the receive is ordered before the device's current stream
            q.compute.wait_stream(torch.cuda.current_stream(q.device))
            buf.record_stream(q.compute)
    return recvs


def halo_exchange(mesh, queues, cores, events) -> dict:
    """The wide planes (H, w + 2 halo) of this process's tiles from their
    deblocked cores (shard.py:46-57): each core with its left neighbour's
    right strip and its right neighbour's left strip, zeros at the frame's
    edges. queues/cores/events: {(g, t): ...} of the local tiles, events
    recorded on each tile's compute stream after its step (None on the
    CPU). Each wide plane is made on its tile's stream."""
    n_tiles = mesh.shape[1]
    remote = _remote_strips(mesh, queues, cores)
    wide = {}
    for key in cores:
        g, t = key
        q = queues[key]
        planes = []
        for p, halo in enumerate(HALOS):
            core = cores[key][p]
            parts = []
            for side, nb, cols in (("left", (g, t - 1), slice(-halo, None)),
                                   ("right", (g, t + 1), slice(0, halo))):
                if not 0 <= nb[1] < n_tiles:
                    with q.steps():
                        parts.append(torch.zeros(
                            (core.shape[0], halo), dtype=torch.int16,
                            device=q.device))
                elif not mesh.is_local(nb):
                    parts.append(remote[(key, side, p)])
                else:
                    parts.append(_local_strip(cores[nb][p], cols,
                                              queues[nb], q, events[nb]))
            with q.steps():
                planes.append(torch.cat(
                    [parts[0], core.to(torch.int16), parts[1]], dim=1))
        wide[key] = tuple(planes)
    return wide


def _local_strip(plane, cols, src_q, dst_q, event):
    """A neighbour's strip plane[:, cols] on the receiving tile's device
    and stream, after the neighbour's step (its `event`)."""
    if not dst_q.cuda:
        return plane[:, cols].to(torch.int16)
    dst_q.compute.wait_event(event)
    with src_q.steps(), dst_q.steps():
        strip = plane[:, cols].to(dst_q.device, torch.int16)
    if plane.device == dst_q.device:
        plane.record_stream(dst_q.compute)
    return strip


def new_queues(mesh) -> dict:
    """A DeviceQueue for each of this process's tiles."""
    return {key: DeviceQueue(mesh.device(key)) for key in mesh.local_keys()}
