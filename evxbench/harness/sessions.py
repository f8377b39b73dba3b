"""Encode sessions: one thread each, each owning one encoder of the
program, fed from the frame ring and driven through the encoder's
pipelined `encode_many`, as a streaming host runs one encoder per player.

A session records, on the host's clock, when each frame was due and handed
over, when its chunk came out, the entropy stage of each chunk as the
encoder reports it, and the wall time of each call into the encoder's
dispatch and finish lanes (the harness wraps the two methods; their
arguments and results pass through untouched).
"""

from __future__ import annotations

import threading
import time
import traceback


class Session:
    def __init__(self, index: int, encoder, ring, offset: int):
        self.index = index
        self.enc = encoder
        self.ring = ring
        self.offset = offset
        self.fed = 0            # frames handed to the encoder so far
        self.due = []           # per frame: when it was due
        self.handed = []        # per frame: when it was handed over
        self.ring_index = []    # per frame: its index in the ring
        self.chunks = []        # per frame: its chunk
        self.done = []          # per frame: when its chunk came out
        self.entropy_ms = []    # per frame: the encoder's entropy stage
        self.dispatch = []      # (start, end) of each dispatch call
        self.finish = []        # (start, end) of each finish call
        self.error = None
        self.probe = None       # a check.Probe that snapshots one frame
        self._wrap("_dispatch", self.dispatch, hook=True)
        self._wrap("_finish", self.finish)

    def _wrap(self, name, spans, hook=False):
        fn = getattr(self.enc, name)

        def timed(*args, **kwargs):
            if hook and self.probe is not None:
                self.probe.before(self)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((t0, time.perf_counter()))
                if hook and self.probe is not None:
                    self.probe.after(self)
        setattr(self.enc, name, timed)

    def frames(self, stop: threading.Event, period=None, first_due=None,
               count=None):
        """The frames this session hands over: until `stop` is set (or
        `count` frames), at once (closed loop) or each at its due time,
        `first_due` + k `period` (open loop)."""
        k0 = self.fed
        while not stop.is_set() and (count is None or self.fed - k0 < count):
            due = None
            if period is not None:
                due = first_due + (self.fed - k0) * period
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                if stop.is_set():
                    return
            handed = time.perf_counter()
            self.due.append(handed if due is None else due)
            self.handed.append(handed)
            k = (self.offset + self.fed) % len(self.ring)
            self.ring_index.append(k)
            self.fed += 1
            yield self.ring[k]

    def run(self, frames):
        """Drives encode_many over `frames`, recording each chunk."""
        try:
            for chunk in self.enc.encode_many(frames):
                self.done.append(time.perf_counter())
                self.chunks.append(chunk)
                self.entropy_ms.append(
                    self.enc.last_stats["stage_ms"]["entropy"])
        except Exception:  # noqa: BLE001 - reported as the run's failure
            self.error = traceback.format_exc()

    def start(self, frames) -> threading.Thread:
        thread = threading.Thread(target=self.run, args=(frames,),
                                  name=f"session-{self.index}", daemon=True)
        thread.start()
        return thread
