"""waterfill_us_per_launch (kernels): device time of the profiled
slice's kernels whose name holds ``waterfill``, over the launches of the
one-block and cluster float64 water-filling kernels that the program
counted in the slice."""

KERNELS = "waterfill"
COUNTERS = ("kernels.waterfill_f64.launches",
            "kernels.waterfill_f64_cluster.launches")


def read(r):
    launches = sum(r.slice_counters[c] for c in COUNTERS)
    if r.slice is None or not launches:
        return None
    us = sum(e - s for name, s, e in r.slice.kernels() if KERNELS in name)
    if not us:
        return None
    return us / launches
