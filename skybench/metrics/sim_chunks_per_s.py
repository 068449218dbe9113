"""sim_chunks_per_s (end to end): chunks delivered by all the sims of the
window over the window's whole wall time, from the first sim's start to
the last one's return: how fast a caller of the sim gets transfers
predicted."""


def read(r):
    if not r.window_chunks or r.window_s <= 0:
        return None
    return r.window_chunks / r.window_s
