"""Pipelined encode and decode: the lanes of cairo_tpu/tpu/api.py's
encode_many / decode_many, on CUDA streams, events and pinned host
buffers.

Each encoder and decoder owns a DeviceQueue. On a CUDA device it holds
  * a compute stream of its own: every upload, device step and state read
    of the instance is enqueued there (the kernel wrappers launch on the
    current stream, _build.launch);
  * a copy stream for the downloads: a download first waits on the event
    recorded after the step that wrote its tensors (the counterpart of
    JAX's copy_to_host_async), and copies into pinned host memory;
  * a ring of UPLOAD_SLOTS pinned staging buffers for the uploads: a
    buffer is refilled only after the event of the copy that last read it.
Worker threads read device memory only through it. A thread's current
stream is the legacy default stream, which the instance's streams do not
synchronise with, so every read off the main thread waits on the event of
the frame that wrote it. A tensor read on the copy stream is marked with
record_stream, so that the caching allocator does not hand its memory to
a later step before the read is done. On the CPU the same calls run with
no streams, events or pinned memory, and the lanes' threads and ordering
are the same, so the CPU tests exercise them.

The lanes, as the JAX package runs them:
  * encode (pipelined_encode): the main thread dispatches frame N (upload,
    step, the start of its output's download); a worker converts frame
    N+1's RGB to the source wire meanwhile, under the frame index and
    quality it will carry (used only if both still match at its
    dispatch); a worker fetches frame N-1's output and entropy-codes it,
    and chunk N-1 is yielded while frame N runs;
  * decode (pipelined_decode): the main thread parses and dispatches chunk
    N+1 (decode_slice, extract_coo, the schedule, the upload, the step), a
    fetch lane waits for frame N's YUV wire and a convert lane turns it
    into RGB. At most two frames are in flight, fewer than the ring's 4
    slots, so a frame's ring slot is rewritten only after its
    convert lane is done with it.
A worker's exception propagates out of the generator when its result is
read; the executors' shutdown waits for the lanes, so nothing is left
running.

Every encoder and decoder records its lanes into its span log,
`enc.spans` (spans.py: a bounded deque that keeps at least the last 4096
frames; no synchronisation and no event). Each span carries the frame
index, its parent, its thread, and start and end on time.perf_counter().
Its thread's CPU seconds (time.thread_time, a system call of some 3 us on
an H100 machine) are read only on the lane methods' own spans and the
waits on the device: encode.dispatch, encode.finish, upload.slot_wait and
finish.fetch, and the decoder's decode.dispatch, decode.fetch and
decode.convert; seven reads an encoded frame. Measured there
(tools/span_cost.py), a span costs some 1 us of its thread, one that
reads CPU time some 7 us, an encoded frame 38-49 us. The encoders'
spans, by lane:
  * main thread (pipelined_encode): encode.hold, the wait in next() for
    the next frame while the current one is held undispatched;
    encode.wire_wait, the wait for the wire converted ahead;
    encode.chunk_wait, the wait for the previous frame's finish (under
    that frame's index); encode.yield_lag, from the end of a frame's
    encode.finish to the yield of its chunk (two stamps, on two threads:
    no CPU time);
  * main thread (_dispatch): encode.dispatch, all of it, with children
    dispatch.convert (only where no wire came ahead), dispatch.upload
    (child upload.slot_wait, DeviceQueue.upload's wait for its staging
    slot), dispatch.step (the engine's step: its Python and its
    launches) and dispatch.download (pinned buffers, copies issued,
    event);
  * worker (pipelined_encode): encode.convert_ahead, the next frame's
    rgb_to_yuv5d;
  * worker (_finish): encode.finish, all of it, with children
    finish.fetch (the download's wait; on the fast path also the wire's
    unpacking), finish.entropy (encode_slice) and finish.stats
    (frame_stats and the stale-field bookkeeping).
Counters, at the same boundaries: bytes.upload (an upload's packed
bytes) and bytes.download (a download's tensors). The decoder's: on the
main thread decode.dispatch with child dispatch.entropy (decode_slice),
on the fetch lane decode.fetch, on the convert lane decode.convert.
encode() and decode() record the same spans of _dispatch / _finish and
_dispatch_decode / _fetch_decode / _finish_decode. last_stats["stage_ms"]
is read from the frame's spans.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..spans import NullLog

UPLOAD_SLOTS = 4
ALIGN = 16  # byte alignment of each array in a packed upload
NULL = NullLog()


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class Download:
    """Host copies of device tensors, in flight on the copy stream."""

    def __init__(self, host: dict, done):
        self._host = host
        self._done = done

    def wait(self) -> dict:
        """The numpy arrays, once the copies are done (releases the GIL
        while waiting)."""
        if self._done is not None:
            self._done.synchronize()
        return {k: h.numpy() for k, h in self._host.items()}


class DeviceQueue:
    """The streams, events and pinned buffers of one encoder or decoder on
    `device` (none on the CPU). `spans`: the owner's SpanLog, which an
    upload or download given the `frame` it belongs to records into (its
    bytes, and an upload's wait for its staging slot)."""

    def __init__(self, device: torch.device, spans=None):
        self.device = device
        self.cuda = device.type == "cuda"
        self.spans = NULL if spans is None else spans
        if self.cuda:
            self.compute = torch.cuda.Stream(device)
            self.copy = torch.cuda.Stream(device)
            self._staging = [None] * UPLOAD_SLOTS
            self._copied = [None] * UPLOAD_SLOTS
            self._slot = 0

    def steps(self):
        """Context in which the instance's device work is enqueued: its
        compute stream."""
        return torch.cuda.stream(self.compute) if self.cuda \
            else contextlib.nullcontext()

    def upload(self, *arrays, frame=None) -> list:
        """Host arrays -> device tensors, one each, ordered on the compute
        stream before the work enqueued after it; the host arrays may be
        rewritten as soon as this returns. On a card the arrays travel
        packed in one pinned staging buffer. Main thread only. With a
        `frame`, records the bytes packed and the span upload.slot_wait
        (the wait for the staging slot; nothing to wait for on the
        CPU)."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // ALIGN) * ALIGN
        log = self.spans if frame is not None else NULL
        log.count("bytes.upload", frame, total)
        begun = log.stamp(cpu=True)
        if not self.cuda:
            log.span("upload.slot_wait", frame, "dispatch.upload", begun)
            return [torch.from_numpy(a.copy()) for a in arrays]
        i = self._slot
        self._slot = (i + 1) % UPLOAD_SLOTS
        if self._copied[i] is not None:
            self._copied[i].synchronize()  # the copy that last read it
        log.span("upload.slot_wait", frame, "dispatch.upload", begun)
        if self._staging[i] is None or self._staging[i].numel() < total:
            self._staging[i] = torch.empty(total, dtype=torch.uint8,
                                           pin_memory=True)
        staged = self._staging[i][:total]
        host = staged.numpy()
        for a, o in zip(arrays, offsets):
            host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        with self.steps():
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            dev.copy_(staged, non_blocking=True)
            self._copied[i] = self.mark()
        return [dev[o:o + a.nbytes].view(_torch_dtype(a.dtype)).view(a.shape)
                for a, o in zip(arrays, offsets)]

    def mark(self):
        """An event recorded on the compute stream after the work enqueued
        so far (None on the CPU)."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(self.compute)
        return event

    def download(self, tensors: dict, after, frame=None) -> Download:
        """Starts copying `tensors` to pinned host memory on the copy
        stream once the event `after` is reached. Any thread. With a
        `frame`, records their bytes."""
        if frame is not None:
            self.spans.count("bytes.download", frame, sum(
                t.numel() * t.element_size() for t in tensors.values()))
        if not self.cuda:
            return Download(dict(tensors), None)
        self.copy.wait_event(after)
        host = {}
        with torch.cuda.stream(self.copy):
            for k, t in tensors.items():
                host[k] = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                host[k].copy_(t, non_blocking=True)
                t.record_stream(self.copy)
            done = torch.cuda.Event()
            done.record(self.copy)
        return Download(host, done)

    def fetch(self, tensor, after, frame=None) -> np.ndarray:
        """`tensor` on the host as the step before the event `after` left
        it. Any thread; returns when the copy is done."""
        return self.download({"t": tensor}, after, frame).wait()["t"]

    def read(self, tensor) -> np.ndarray:
        """A host copy of `tensor` after everything enqueued on the compute
        stream so far (state reads: checkpoints, peeks)."""
        with self.steps():
            return tensor.to("cpu", copy=True).numpy()


def pipelined_encode(enc, frames):
    """encode_many of GpuEncoder and ConformanceGpuEncoder: the lanes of
    TpuEncoder.encode_many (tpu/api.py:208-245). Yields one chunk per
    frame; `enc.last_stats` is the yielded frame's. One step moves: frame
    N+1's conversion is submitted before frame N's dispatch, under the
    frame index that dispatch advances to, where JAX submits it after.
    JAX's dispatch returns at once; the port's holds the main thread
    while it launches the step's kernels, and a conversion submitted
    after it would be waited for at the next frame. Only the consumer changes the quality
    and frame index a wire is made with, between yields, so both orders
    make the same wires and chunks. Records the lanes' spans into
    `enc.spans` (the module's docstring lists them)."""
    log = enc.spans

    def convert(frame, frame_index):
        return (pool.submit(_convert_ahead, log, frame, enc._aw, enc._ah,
                            frame_index, enc.quality),
                frame_index, enc.quality)

    it = iter(frames)
    with ThreadPoolExecutor(2) as pool:
        fin = None  # (future, pending) of the previous frame's finish
        pre = None  # (future, frame_index, quality) of cur's wire
        cur = next(it, None)
        while cur is not None:
            frame = enc.frame_index
            begun = log.stamp()
            nxt = next(it, None)
            log.span("encode.hold", frame, None, begun)
            ahead = None
            if nxt is not None and enc._state is not None:
                ahead = convert(nxt, enc.frame_index + 1)
            wire = None
            if pre is not None:
                fut, exp_index, exp_q = pre
                begun = log.stamp()
                w = fut.result()
                log.span("encode.wire_wait", frame, None, begun)
                # a set_quality between yields changes the quality the
                # wire's header carries
                if exp_index == enc.frame_index and exp_q == enc.quality:
                    wire = w
            pending = enc._dispatch(cur, src_wire=wire)
            if nxt is not None and ahead is None:
                # the first frame's dispatch sets the aligned sizes
                ahead = convert(nxt, enc.frame_index)
            pre, cur = ahead, nxt
            if fin is not None:
                yield _chunk(log, *fin)
            fin = pool.submit(enc._finish, pending), pending
        if fin is not None:
            yield _chunk(log, *fin)


def _convert_ahead(log, rgb, aw, ah, frame_index, quality):
    """The source wire of the next frame, on a worker."""
    begun = log.stamp()
    wire = native.rgb_to_yuv5d(rgb, aw, ah, frame_index, quality)
    log.span("encode.convert_ahead", frame_index, None, begun)
    return wire


def _chunk(log, fin, pending):
    """The finished frame's chunk, once its finish is done; records the
    wait for it and the lag from the finish's end to the yield that
    follows."""
    frame = pending["frame_index"]
    begun = log.stamp()
    chunk = fin.result()
    log.span("encode.chunk_wait", frame, None, begun)
    log.join("encode.yield_lag", frame, None, pending["finished"])
    return chunk


def pipelined_decode(dec, chunks):
    """decode_many of GpuDecoder: the three lanes of TpuDecoder.decode_many
    (tpu/api.py:692-712). Yields one RGB frame per chunk; `dec.last_stats`
    is the yielded frame's."""
    with ThreadPoolExecutor(1) as fetch_pool, \
            ThreadPoolExecutor(1) as convert_pool:
        fut = None
        for chunk in chunks:
            nxt = dec._dispatch_decode(chunk)
            if fut is not None:
                yield fut.result()
            fetched = fetch_pool.submit(dec._fetch_decode, nxt)
            fut = convert_pool.submit(
                lambda f=fetched: dec._finish_decode(f.result()))
        if fut is not None:
            yield fut.result()
