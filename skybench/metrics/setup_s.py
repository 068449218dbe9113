"""setup_s (end to end): seconds from the process's start to the first
timed sim: imports, the card's context, the water-filling library (built
by nvcc at a checkout's first run, loaded after), the cell's inputs and
one warm-up slice of its own shapes."""


def read(r):
    return r.setup_s
