"""useful_iteration_share (graph blocks): the share of the device's loop
iterations that were events, the window's results' ``events`` over the
program's counter ``sim.iterations``. The rest are predicated no-op
iterations left in a block after the loop's flag went down, before the
host reads it."""

COUNTERS = ("sim.iterations",)


def read(r):
    if not r.window_counters["sim.iterations"]:
        return None
    return 100.0 * r.window_events / r.window_counters["sim.iterations"]
