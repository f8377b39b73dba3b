"""A device trace over a stretch of the measured window: torch.profiler
with device activity only (no host operator events, so the host's lanes
run almost as they do untraced), recorded after one warm-up step as the
profiler's schedule has it (a trace that records from its first step
loses that step's kernels).

From the trace: every device operation's interval on the host's clock,
the kernel launches among them, and the longest stretches with nothing
running on the device, each named by what the sessions' lanes were doing
then."""

from __future__ import annotations

import time

from . import stats

COPY_PREFIXES = ("Memcpy", "Memset")


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1),
                             on_trace_ready=self._read)
        self.t0 = self.t1 = None
        self.ops = []   # (name, start, end) on the host's perf_counter clock

    def enter(self):
        """Starts the profiler's warm-up step."""
        self._prof.__enter__()

    def begin(self):
        """Starts recording."""
        self._prof.step()
        self.t0 = time.perf_counter()

    def end(self):
        """Stops recording; the profiler hands the trace to _read."""
        self.t1 = time.perf_counter()
        self._prof.step()
        self._prof.__exit__(None, None, None)

    def _read(self, prof):
        """Takes the trace's device operations (the profiler clears its
        events at the end of each cycle, so they are read here)."""
        from torch.autograd import DeviceType

        raw = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
                raw.append((e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9))
        # the trace's clock is the wall clock or the monotonic one: take the
        # one under which the operations fall inside the recorded stretch
        best = None
        for offset in (time.time() - time.perf_counter(),
                       time.monotonic() - time.perf_counter()):
            inside = sum(1 for _, s, _ in raw
                         if self.t0 - 1 <= s - offset <= self.t1 + 1)
            if best is None or inside > best[0]:
                best = (inside, offset)
        offset = best[1] if best else 0.0
        self.ops = [(n, s - offset, e - offset) for n, s, e in raw]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def intervals(self):
        return [(s, e) for _, s, e in self.ops]

    def kernels(self):
        return [op for op in self.ops if not op[0].startswith(COPY_PREFIXES)]

    def busy_s(self) -> float:
        return stats.union_length(self.intervals(), self.t0, self.t1)

    def idle_pct(self) -> float:
        return stats.idle_share(self.intervals(), self.t0, self.t1)

    def launches(self) -> int:
        return sum(1 for _, s, _ in self.kernels() if self.t0 <= s <= self.t1)

    def kernel_ms(self, name: str):
        """(launches, mean device ms a launch) of the kernels whose name
        holds `name`, in the recorded stretch; None if there was none."""
        times = [e - s for n, s, e in self.kernels()
                 if name in n and self.t0 <= s <= self.t1]
        if not times:
            return None
        return len(times), 1e3 * sum(times) / len(times)

    def top_ops(self, n=10):
        totals = {}
        for name, s, e in self.ops:
            if self.t0 <= s <= self.t1:
                key = short_name(name)
                totals[key] = totals.get(key, 0.0) + (e - s)
        return sorted(([k, v] for k, v in totals.items()),
                      key=lambda kv: -kv[1])[:n]

    def top_gaps(self, sessions, n=10):
        """The longest idle stretches, each named by how many sessions were
        in their dispatch and finish lanes at its middle."""
        out = []
        for lo, hi in stats.idle_gaps(self.intervals(), self.t0, self.t1)[:n]:
            mid = (lo + hi) / 2
            d = sum(any(a <= mid <= b for a, b in s.dispatch) for s in sessions)
            f = sum(any(a <= mid <= b for a, b in s.finish) for s in sessions)
            out.append([f"dispatch x{d}, finish x{f}", hi - lo])
        return out


def short_name(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    head = name.split("(")[0]
    if head.startswith("void "):
        head = head[5:]
    return head.split("<")[0][:80] or name[:80]
