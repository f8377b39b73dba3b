"""The 95th percentile, over every frame due inside the window in every
session, of the ms from the frame's due time to its chunk. A frame whose
chunk never came has no time and counts above every other."""

from harness import stats


def read(run):
    lat, missing = run.latencies()
    if missing:
        lat = lat + [float("inf")] * missing
    value = 1e3 * stats.percentile(lat, 95)
    return value if value != float("inf") else None
