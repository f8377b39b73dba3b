"""The metrics' arithmetic on synthetic timelines."""

import pytest

import tiny  # noqa: F401  (puts the harness and the port on the path)
from harness import stats
from harness.cell import Run
from harness.sessions import Session


def test_rate_counts_only_the_window():
    done = [0.5, 1.0, 1.5, 2.0, 10.5, 11.0]
    assert stats.rate(done, 1.0, 10.0) == pytest.approx(5 / 10)


def test_rate_with_a_stall_inside_the_window():
    # 10 chunks a second for 2 s, nothing for 6 s, then 10 a second again
    done = [i / 10 for i in range(20)] + [8 + i / 10 for i in range(20)]
    assert stats.rate(done, 0.0, 10.0) == pytest.approx(4.0)


def test_percentile_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 50) == 50
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_latencies_and_a_frame_never_done():
    due = [0.0, 1.0, 2.0, 3.0, 12.0]
    done = [0.1, 1.2, None, 3.05, 12.1]
    lat, missing = stats.latencies(due, done, 0.5, 10.0)
    assert lat == pytest.approx([0.2, 0.05]) and missing == 1


def _session(due, done):
    s = Session.__new__(Session)
    s.due, s.done, s.handed = list(due), list(done), list(due)
    s.dispatch, s.finish = [], []
    return s


def test_p95_counts_a_missing_frame_above_every_other():
    from harness.cell import _reader

    # 20 frames due in the window, one never done: its place is the top
    s = _session([i * 0.1 for i in range(20)],
                 [i * 0.1 + 0.01 * (i + 1) for i in range(19)])
    run = Run(64, 48, [s], 0.0, 2.0, 1.0, None)
    lat, missing = run.latencies()
    assert missing == 1 and len(lat) == 19
    assert _reader("end_to_end", "encode_p95_ms")(run) == pytest.approx(190)
    s2 = _session([0.0, 0.1], [None, None])
    s2.done = []
    run2 = Run(64, 48, [s2], 0.0, 2.0, 1.0, None)
    assert _reader("end_to_end", "encode_p95_ms")(run2) is None


def test_stall_moves_the_tail_not_the_median():
    # 100 frames at 30 frames/s; a 0.5 s stall holds back the frames due in it
    due = [i / 30 for i in range(100)]
    done = [d + 0.05 for d in due]
    for i in range(30, 45):
        done[i] = 1.5 + 0.05 + (i - 30) * 0.001
    lat, _ = stats.latencies(due, done, 0.0, 10.0)
    assert stats.percentile(lat, 50) == pytest.approx(0.05)
    assert stats.percentile(lat, 95) > 0.3


def test_idle_share_union_of_overlapping_streams():
    ops = [(0.0, 1.0), (0.5, 1.5), (3.0, 4.0), (9.5, 11.0)]
    assert stats.union_length(ops, 0.0, 10.0) == pytest.approx(3.0)
    assert stats.idle_share(ops, 0.0, 10.0) == pytest.approx(70.0)
    gaps = stats.idle_gaps(ops, 0.0, 10.0)
    assert gaps[0] == pytest.approx((4.0, 9.5))
    assert gaps[1] == pytest.approx((1.5, 3.0))
    assert stats.idle_share([], 0.0, 10.0) == 100.0


def test_host_metrics_of_a_traced_run_take_the_window_before_the_trace():
    from harness.cell import _reader

    class Trace:
        t0, t1 = 8.0, 9.0

    s = _session([i * 0.5 for i in range(20)], [i * 0.5 + 0.1
                                                for i in range(20)])
    s.dispatch = [(t, t + (0.010 if t <= 8.0 else 0.500))
                  for t in s.due]
    run = Run(64, 48, [s], 0.0, 10.0, 1.0, Trace())
    assert _reader("layer_metrics", "dispatch_ms")(run) == pytest.approx(10)
    lat, _ = run.latencies()
    assert len(lat) == 17
