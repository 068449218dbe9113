"""graph_capture_ms_per_sim (sim host loop): milliseconds of CUDA-graph
capture and instantiation a sim pays, from the program's counter
``sim.graph_capture_s`` over the window's sims. Every sim call captures
its blocks anew, so this is set-up the caller pays on each prediction."""

COUNTERS = ("sim.graph_capture_s", "sim.graph_captures")


def read(r):
    if not r.window_sims or not r.window_counters["sim.graph_captures"]:
        return None
    return r.window_counters["sim.graph_capture_s"] * 1e3 / r.window_sims
