"""launches_per_iteration (device iteration): kernel records of the
profiled slice (copies and sets left out) over the loop iterations it
ran (counter ``sim.iterations``)."""

COUNTERS = ("sim.iterations",)


def read(r):
    it = r.slice_counters["sim.iterations"]
    if r.slice is None or not r.slice.kernels() or not it:
        return None
    return len(r.slice.kernels()) / it
