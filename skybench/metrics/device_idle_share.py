"""device_idle_share (device): the share of the profiled slice's span in
which the device ran nothing, one minus the union of its device records
over the span (the result line's ``busy_s`` over ``window_s``). The span
holds the sim's own set-up (state build, eager first block, graph
capture) and the profiler's cost: under CUPTI each kernel node of a
replayed graph costs the host time, so the span is longer than the same
slice unprofiled. ``PERF.md`` gives both against an unprofiled sim."""


def read(r):
    if r.slice is None or not r.slice.device or r.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.slice.busy_s() / r.slice.window_s)
