"""One run of one cell: set-up, the measured window, the profiled slice,
the comparison with the reference, and the result's line.

The window is a closed loop with one caller: each sim of the cell's jobs
(``repro_torch.transfer.simulate(..., engine="torch")``) starts when the
last has returned, with its own sim seed drawn from ``--seed``, while the
window's ``--seconds`` have not run out; the window ends when the last
sim returns. With ``--trace 1`` a slice of one more sim (cut at the
traffic's ``slice_horizon_s``, or whole where that is null) then runs
under ``torch.profiler``. Once the program is done and the device's peak
memory read, the frozen reference runs each distinct sim seed of the
window once on the CPU, and ``judge`` holds every sim against its seed's
result; the slice is run again on its own, at its horizon.

Every metric is read by its file ``metrics/<name>.py`` from
``Readings``: the end-to-end ones with ``--trace 0``, the per-layer ones
with ``--trace 1``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time

from skybench import cells, devtrace, judge, roofline

# top-level module names that may not be loaded in the benchmark's
# process: JAX and the JAX package the port was made from
BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Readings:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    window_sims: int
    window_events: int  # the results' events, summed
    window_chunks: int  # chunks delivered, summed over jobs and sims (a
    # multicast job's summed over its destinations)
    window_counters: dict  # the program's counters over the window
    slice: devtrace.Slice | None = None
    slice_counters: dict = dataclasses.field(default_factory=dict)
    slice_solves: list = dataclasses.field(default_factory=list)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0]


def delivered(job) -> int:
    """A job result's chunks delivered: a multicast job's summed over its
    destinations (its ``chunks_delivered`` counts only the chunks that
    reached every one)."""
    if job.per_dst_delivered is None:
        return job.chunks_delivered
    return sum(job.per_dst_delivered.values())


def _reference_sim(inputs, seed: int, **kw):
    from skybench.reference.transfer import flowsim

    return flowsim._simulate_multi_impl(
        inputs.ref_jobs, (), seed=seed, **inputs.knobs, **kw)


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t0: float | None = None,
        err=sys.stderr) -> dict:
    """Run ``cell`` once; returns the result's line as a dict. ``t0`` is
    the process's start on ``time.perf_counter``'s clock."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.transfer import simulate

    cuda = device == "cuda"
    torch.set_num_threads(1)  # the loop's host side is one thread's work
    names = cell.per_layer if trace else cell.end_to_end
    readers = {n: cells.metric_reader(n) for n in names}
    counters = sorted({c for m in readers.values()
                       for c in getattr(m, "COUNTERS", ())})

    def snapshot() -> dict:
        return {c: REGISTRY.counter(c).value for c in counters}

    def since(before: dict) -> dict:
        return {c: v - before[c] for c, v in snapshot().items()}

    phases = {"imports": time.perf_counter()}
    inputs = cells.build_inputs(cell)
    phases["inputs"] = time.perf_counter()
    warm_horizon = cell.traffic["warmup_horizon_s"]
    horizon = cell.traffic["slice_horizon_s"]  # None: the whole sim
    if cuda:
        from repro_torch.kernels.waterfill import build

        build.load()  # nvcc at a checkout's first run, then the cached .so
        torch.zeros(1, device="cuda")  # the card's context
    phases["context and library"] = time.perf_counter()

    def sim(s: int, **kw):
        res = simulate(inputs.jobs, (), engine="torch",
                       device=device, seed=s, **inputs.knobs, **kw)
        if cuda:
            torch.cuda.synchronize()
        return res

    seeds = cells.sim_seeds(seed, cell.traffic["sim_seed_pool"])
    sim(next(seeds), horizon_s=warm_horizon)  # the cell's own shapes
    phases["warm-up"] = time.perf_counter()

    # ---------------------------------------------------------- the window
    before = snapshot()
    done = []
    start = time.perf_counter()
    deadline = start + seconds
    walls = []
    while True:
        s = next(seeds)
        res = sim(s)
        walls.append(time.perf_counter())
        done.append((s, res))
        if walls[-1] >= deadline:
            break
    end = walls[-1]
    r = Readings(
        setup_s=start - t0, window_s=end - start, window_sims=len(done),
        window_events=sum(res.events for _, res in done),
        window_chunks=sum(delivered(j) for _, res in done
                          for j in res.jobs),
        window_counters=since(before))

    sliced = None
    if trace:
        s_slice = next(seeds)
        before = snapshot()
        t = time.perf_counter()
        res, r.slice = devtrace.profiled(
            lambda: sim(s_slice, horizon_s=horizon), cuda)
        r.slice_counters = since(before)
        print(f"skybench: profiled slice {r.slice.window_s:.3f} s, "
              f"{len(r.slice.device)} device records, "
              f"{time.perf_counter() - t:.3f} s in all", file=err)
        sliced = (s_slice, res)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    card = card_line() if cuda else "no card"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ------------------------------------------- the reference, afterwards
    t = time.perf_counter()
    refs = {s: _reference_sim(inputs, s)
            for s in dict.fromkeys(s for s, _ in done)}
    readings = [judge.compare(res, refs[s]) for s, res in done]
    ref_s = time.perf_counter() - t
    if sliced is not None:
        from skybench.reference.transfer import flowsim

        with roofline.counting_solves(flowsim) as solves:
            ref = _reference_sim(inputs, sliced[0], horizon_s=horizon)
        r.slice_solves = list(solves)
        readings.append(judge.compare(sliced[1], ref))
    failed = sum(not judge.within(x) for x in readings)
    checks = judge.merge(readings)

    metrics = {}
    for name, reader in readers.items():
        v = reader.read(r)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": cell.units[name]}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips if cuda else 1,
        "memory_peak_bytes": int(peak),
    }
    line = {"correct": failed == 0, "attempted": len(readings),
            "failed": failed, "metrics": metrics, "device": dev}
    if trace and r.slice is not None:
        dev["busy_s"] = r.slice.busy_s()
        dev["window_s"] = r.slice.window_s
        line["breakdown"] = {"device_ops": r.slice.top_device_ops(),
                             "idle_gaps": r.slice.idle_gaps()}
    line["checks"] = {k: {"value": checks[k], "limit": lim}
                      for k, lim in judge.LIMITS.items()}
    marks, last = [], t0
    for name, at in phases.items():
        marks.append(f"{name} {at - last:.3f} s")
        last = at
    marks = ", ".join(marks)
    print(f"skybench: {cell.name} on {card}: set-up {r.setup_s:.3f} s "
          f"({marks}); {len(done)} sims in {r.window_s:.3f} s; "
          f"the reference {ref_s:.3f} s for their {len(refs)} sim seeds",
          file=err)
    print("skybench: sim seconds " + " ".join(
        f"{b - a:.4f}" for a, b in zip([start, *walls], walls)), file=err)
    for k, lim in judge.LIMITS.items():
        print(f"check {k} {checks[k]!r} limit {lim!r}", file=err)
    return line


def emit(line: dict, out=sys.stdout) -> None:
    print(json.dumps(line), file=out, flush=True)
