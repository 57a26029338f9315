"""Layer ``kernels``: the ``fork_ss`` kernel's share of its roofline,
in %: the least time of the strongly-see calls recorded while the
profiler ran (``roofline/fork_ss.py``) over the device time the profiler
gives the kernel in that span.  Moves ``ordered_events_per_s``."""

from port_bench.roofline import fork_ss


def read(run):
    tr, dev = run["trace"], run["device_info"]
    calls = run["calls"].get("fork_ss")
    if not tr or not calls or not dev or not dev.get("sm_clock_max_hz"):
        return None
    t = sum(s for name, s in tr["kernels_s"].items() if "fork_ss" in name)
    if t <= 0:
        return None
    least, _ = fork_ss.least_seconds(calls, dev)
    return 100.0 * least / t
