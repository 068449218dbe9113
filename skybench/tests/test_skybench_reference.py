"""The frozen reference against the program's CPU engine, field for
field, on a tiny job of each configuration. The only test that imports
both sides' sim modules."""

import dataclasses

import pytest

from skybench.tests.tiny import CELLS, tiny


def _both(cell, seed):
    from repro_torch.transfer import simulate
    from skybench import cells
    from skybench.reference.transfer import flowsim

    inputs = cells.build_inputs(cell)
    prog = simulate(inputs.jobs, (), engine="torch", device="cpu",
                    seed=seed, **inputs.knobs)
    ref = flowsim._simulate_multi_impl(inputs.ref_jobs, (), seed=seed,
                                       **inputs.knobs)
    return prog, ref


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_reference_equals_the_programs_cpu_engine(name, seed):
    from skybench import cells, judge

    cell = tiny(name)
    prog, ref = _both(cell, next(cells.sim_seeds(
        seed, cell.traffic["sim_seed_pool"])))
    assert dataclasses.asdict(prog) == dataclasses.asdict(ref)
    assert judge.compare(prog, ref) == {"fields_differing": 0,
                                        "max_rel_gap": 0.0}
    assert all(j.status == "done" for j in ref.jobs)
