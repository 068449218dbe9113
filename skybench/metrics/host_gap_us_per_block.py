"""host_gap_us_per_block (sim host loop): microseconds the device waits
on the host between blocks, the program's counter ``sim.block_gap_s``
(from a flag read's return to the return of the next graph replay's
launch) over its flag reads (``sim.flag_reads``). A flag read followed by
something else than a replay (the end of a segment, a capture, a
sequential cascade) adds a read and no gap: two of ~313 reads a sim in
``direct-2vm.bulk``. None where no gap was measured (the CPU, or a
program without the counters)."""

COUNTERS = ("sim.block_gap_s", "sim.flag_reads")


def read(r):
    gap, reads = (r.window_counters[c] for c in COUNTERS)
    if not gap or not reads:
        return None
    return gap * 1e6 / reads
