"""device_us_per_iteration (device iteration): microseconds in which the
device ran an operation, the union of the profiled slice's device
records, over the loop iterations the slice ran (counter
``sim.iterations``)."""

COUNTERS = ("sim.iterations",)


def read(r):
    it = r.slice_counters["sim.iterations"]
    if r.slice is None or not r.slice.device or not it:
        return None
    return r.slice.busy_s() * 1e6 / it
