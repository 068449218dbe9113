"""waterfill_us_per_solve (kernels): device time of the profiled slice's
kernels whose name holds ``waterfill``, over the solves the program made
in the slice (counter ``sim.solves``); the launches that answered from
the cached rates are charged to the solves. None where the program
counts no solve (a program without the counter reads 0)."""

KERNELS = "waterfill"
COUNTERS = ("sim.solves",)


def read(r):
    solves = r.slice_counters["sim.solves"]
    if r.slice is None or not solves:
        return None
    us = sum(e - s for name, s, e in r.slice.kernels() if KERNELS in name)
    if not us:
        return None
    return us / solves
