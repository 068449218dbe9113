"""Each cell cut to a size a CPU runs in a second or two."""

import dataclasses

CELLS = ("direct-2vm.bulk",)
# a tiny copy of each cell: jobs, chunks a job, horizons
TINY = {"direct-2vm.bulk": (1, 200, 10.0, 10.0)}


def tiny(name: str):
    """The cell ``name`` with fewer jobs and chunks (its shapes of a job
    kept): the same harness, configuration keys and traffic keys."""
    from skybench import cells

    c = cells.load_cell(name)
    jobs, chunks, warm, sliced = TINY[name]
    return dataclasses.replace(
        c, config={**c.config, "jobs": min(jobs, c.config["jobs"])},
        traffic={**c.traffic, "chunks_per_job": chunks,
                 "warmup_horizon_s": warm, "slice_horizon_s": sliced})
