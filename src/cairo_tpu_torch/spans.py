"""A flight recorder of the encode and decode lanes: spans and counters,
per frame, in a bounded in-memory log that each encoder and decoder owns
(`enc.spans`, gpu/api.py; which lane records which span: gpu/pipeline.py).

A span is (name, frame, parent, thread, start, end, cpu): the frame index
it belongs to (the identifier every span of one frame shares), the name of
its parent span (None at the top), the thread that recorded it
(threading.get_ident), start and end on time.perf_counter() (the clock of
the host's other timestamps, and the one a device trace is mapped onto),
and the thread's CPU seconds over it (time.thread_time), or None. A
counter is (name, frame, thread, at, value). Spans are recorded when their
work completes; work that raises leaves none.

The log is always on. perf_counter costs some 0.1 us a read, but
thread_time is a system call, some 3 us a read on the H100 machine it was
measured on (0.5 us on a plain Linux host), so only a span begun from a stamp taken with
`cpu=True` reads it, at both ends: the lanes' own spans and the waits on
the device (gpu/pipeline.py lists them); the others carry None. No device
synchronisation, no event, no allocation beyond the log's bound.
Appends from several threads are safe under the GIL (deque.append is
atomic), and so is a snapshot (`records`). The log keeps the last
FRAMES * RECORDS_PER_FRAME records: at least the last FRAMES frames of a
lane that records up to RECORDS_PER_FRAME records a frame (an encoder
records some 16-21), some 22 MB when full.
"""

from __future__ import annotations

import threading
import time
from collections import deque, namedtuple

FRAMES = 4096
RECORDS_PER_FRAME = 24

Span = namedtuple("Span", "name frame parent thread start end cpu")
Count = namedtuple("Count", "name frame thread at value")

_now = time.perf_counter
_cpu = time.thread_time
_thread = threading.get_ident


class SpanLog:
    """The bounded log of one encoder or decoder. Record a span with
    `begun = log.stamp()` ... `log.span(name, frame, parent, begun)`;
    `span` returns its own end stamp, without CPU time, which the next
    span of the same thread may take as its start.
    """

    def __init__(self):
        self._log = deque(maxlen=FRAMES * RECORDS_PER_FRAME)

    def stamp(self, cpu=False):
        """(perf_counter, thread_time) now; thread_time None unless
        `cpu`."""
        return _now(), _cpu() if cpu else None

    def span(self, name, frame, parent, begun):
        """Records the span from the stamp `begun` (taken on this thread)
        to now, with its CPU seconds if `begun` read them; returns the end
        stamp (wall time only)."""
        end = _now()
        cpu = None if begun[1] is None else _cpu() - begun[1]
        self._log.append((name, frame, parent, _thread(), begun[0], end,
                          cpu))
        return end, None

    def join(self, name, frame, parent, start):
        """Records the span from `start`, a perf_counter time stamped on
        another thread, to now (no CPU time)."""
        self._log.append((name, frame, parent, _thread(), start, _now(),
                          None))

    def count(self, name, frame, value):
        """Records a counter's value for the frame."""
        self._log.append((name, frame, _thread(), _now(), value))

    def records(self) -> list:
        """A snapshot of the log, oldest first."""
        return list(self._log)

    def spans(self, *names) -> list:
        """The spans in the log (those named, if names are given)."""
        return [Span(*r) for r in self.records()
                if len(r) == 7 and (not names or r[0] in names)]

    def counts(self, *names) -> list:
        """The counters in the log (those named, if names are given)."""
        return [Count(*r) for r in self.records()
                if len(r) == 5 and (not names or r[0] in names)]

    def __len__(self):
        return len(self._log)


class NullLog(SpanLog):
    """A log that reads no clock and records nothing (the tiled path's
    queues, which have no per-frame lanes)."""

    def stamp(self, cpu=False):
        return 0.0, None

    def span(self, name, frame, parent, begun):
        return 0.0, None

    def join(self, name, frame, parent, start):
        pass

    def count(self, name, frame, value):
        pass
