"""Each cell of ``BENCHMARK.json`` cut to a size a CPU runs in a second or
two, by one rule for every cell."""

import dataclasses

from skybench import cells

CELLS = tuple(w["name"] for w in cells.manifest()["workloads"])
# the cut: at most this many jobs a sim and chunks a job, and these
# horizons (s) for the warm-up and the profiled slice
JOBS, CHUNKS, WARM_S, SLICE_S = 2, 200, 10.0, 10.0


def cut(cell):
    """``cell`` with fewer jobs and chunks (its shapes of a job kept): the
    same harness, configuration keys and traffic keys."""
    return dataclasses.replace(
        cell, config={**cell.config, "jobs": min(JOBS, cell.config["jobs"])},
        traffic={**cell.traffic,
                 "chunks_per_job": min(CHUNKS,
                                       cell.traffic["chunks_per_job"]),
                 "warmup_horizon_s": WARM_S, "slice_horizon_s": SLICE_S})


def tiny(name: str):
    """The cell ``name`` of the manifest, cut."""
    return cut(cells.load_cell(name))
