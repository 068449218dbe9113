"""state_build_ms_per_sim (sim host loop): milliseconds a sim spends
building its state before the loop, the program's span ``sim.build``
(scenario materialized, schedule sorted, state and constants placed on
the device, blocks set up; counter ``sim.build_s``) over the window's
sims. None where the program has no such span."""

COUNTERS = ("sim.build_s",)


def read(r):
    if not r.window_sims or not r.window_counters["sim.build_s"]:
        return None
    return r.window_counters["sim.build_s"] * 1e3 / r.window_sims
