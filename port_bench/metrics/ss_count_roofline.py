"""Layer ``kernels``: the ``ss_count`` kernel's share of its roofline,
in %: the least time of the compare-count calls recorded while the
profiler ran (``roofline/ss_count.py``) over the device time the
profiler gives the kernel in that span.  Moves
``ordered_events_per_s``."""

from port_bench.roofline import ss_count


def read(run):
    tr, dev = run["trace"], run["device_info"]
    calls = run["calls"].get("ss_count")
    if not tr or not calls or not dev or not dev.get("sm_clock_max_hz"):
        return None
    t = sum(s for name, s in tr["kernels_s"].items() if "ss_count" in name)
    if t <= 0:
        return None
    least, _ = ss_count.least_seconds(calls, dev)
    return 100.0 * least / t
