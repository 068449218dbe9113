"""window_idle_share (device): the share of the measured window in which
the device ran no replayed block, one minus the program's counter
``sim.replay_device_s`` (CUDA events around each graph replay) over the
window's wall time. The window is not profiled, so this is the program's
own idle share: state build, eager first blocks, capture, the host's flag
reads and launches between blocks, and the result's read-back. None
where nothing was replayed (the CPU, or a program without the counter)."""

COUNTERS = ("sim.replay_device_s",)


def read(r):
    busy = r.window_counters["sim.replay_device_s"]
    if not busy or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / r.window_s)
