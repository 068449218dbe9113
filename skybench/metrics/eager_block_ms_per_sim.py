"""eager_block_ms_per_sim (graph blocks): milliseconds a sim spends in
blocks run eagerly, the program's span ``sim.block.eager`` (on the card
the first use of each block length, before its graph is captured;
counter ``sim.block.eager_s``) over the window's sims. None where the
program has no such span."""

COUNTERS = ("sim.block.eager_s",)


def read(r):
    if not r.window_sims or not r.window_counters["sim.block.eager_s"]:
        return None
    return r.window_counters["sim.block.eager_s"] * 1e3 / r.window_sims
