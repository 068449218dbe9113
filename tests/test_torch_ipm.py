"""The port's batched torch IPM against the reference package's engines.

The LPs are the reference's own goal-sweep and pinned-shift batches
(``tests/test_solver_equivalence.py``), built by the reference's
``milp``; the same numpy arrays go to the port's ``ipm_torch`` on the CPU,
to the reference's numpy batch engine and to its jax IPM. The jax IPM
imports only under the x64 shim, installed for this module alone.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

from repro.core import milp, toy_topology
from repro.core.solver.ipm import solve_lp
from repro.core.solver.ipm_batch import solve_lp_batched as np_batched
from repro_torch.core import milp as port_milp
from repro_torch.core import toy_topology as port_toy
from repro_torch.core.solver import ipm_batch as port_batch
from repro_torch.core.solver.ipm_torch import _bucket
from repro_torch.core.solver.ipm_torch import solve_lp_batched as torch_batched
from test_torch_cases import one_thread  # noqa: F401

_SHIMMED = ("repro.core.solver.ipm_jax", "repro.transfer.flowsim_jax")


@pytest.fixture(scope="module")
def jax_batched():
    """The reference's jax IPM, importable under the x64 shim; the shim and
    every module imported under it are removed again on teardown."""
    import jax
    import jax.experimental

    had = hasattr(jax.experimental, "enable_x64")
    if not had:
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    try:
        from repro.core.solver.ipm_jax import solve_lp_batched

        yield solve_lp_batched
    finally:
        if not had:
            del jax.experimental.enable_x64
            for name in _SHIMMED:
                sys.modules.pop(name, None)
                parent, _, child = name.rpartition(".")
                pkg = sys.modules.get(parent)
                if pkg is not None and child in vars(pkg):
                    delattr(pkg, child)


def _goal_sweep():
    top = toy_topology(n=6, seed=4)
    goals = np.array([0.5, 1.5, 2.5, 3.5])
    lp = milp.build_lp(top, 0, 1, float(goals[0]))
    b = np.tile(lp.b_ub[None, :], (len(goals), 1))
    b[:, lp.row_4c] = -goals
    b[:, lp.row_4d] = -goals
    return (lp.c, lp.A_ub, b, lp.A_eq, lp.b_eq), [
        (lp.c, lp.A_ub, b[i], lp.A_eq, lp.b_eq) for i in range(len(goals))
    ]


def _pinned_shifts():
    top = toy_topology(n=6, seed=2)
    struct = milp.structure(top, 0, 1)
    pat = struct.pin_pattern(True, False)
    n_vecs = np.array([
        [2.0, 2.0, 1.0, 1.0, 1.0, 1.0],
        [2.0, 2.0, 0.0, 2.0, 0.0, 1.0],
        [1.0, 1.0, 1.0, 0.0, 0.0, 0.0],
    ])
    b, triv = struct.batch_b_ub(pat, np.full(3, 0.8), n_vecs)
    assert not triv.any()
    seq = []
    for i in range(3):
        lp = struct.lp(0.8, fixed_n=n_vecs[i])
        seq.append((lp.c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq))
    return (
        pat.c_free, pat.A_ub_free, b, pat.A_eq_free,
        struct.b_eq[pat.keep_eq],
    ), seq


_CASES = {"goal_sweep": _goal_sweep, "pinned_shifts": _pinned_shifts}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_torch_ipm_matches_numpy_and_jax_engines(case, jax_batched):
    batch, seq = _CASES[case]()
    xt, ft, okt = torch_batched(*batch, device="cpu")
    xn, fn, okn = np_batched(*batch)
    xj, fj, okj = jax_batched(*batch)
    assert xt.shape == xn.shape and ft.shape == fn.shape
    np.testing.assert_array_equal(okt, okj)
    for i, args in enumerate(seq):
        ref = solve_lp(*args)
        if okt[i]:
            assert ft[i] == pytest.approx(fj[i], rel=1e-6, abs=1e-8)
        if okt[i] and okn[i]:
            assert ft[i] == pytest.approx(fn[i], rel=1e-6, abs=1e-8)
        if okt[i] and ref.ok:
            assert ft[i] == pytest.approx(ref.fun, rel=1e-6, abs=1e-8)
        else:
            # engines may certify different borderline samples, but never
            # disagree on a sample both consider solved
            assert not (okt[i] and ref.ok)


def test_port_milp_assembles_the_reference_lps():
    """The port's copy of milp builds bit-identical LPs (same inputs the
    IPM comparisons above feed both packages)."""
    for seed in range(3):
        rtop, ptop = toy_topology(n=6, seed=seed), port_toy(n=6, seed=seed)
        e = len(rtop.edge_list(0, 1))
        fixed_n = np.full(6, 2.0)
        fixed_m = np.random.default_rng(seed).integers(0, 5, (6, 6)) * 1.0
        for kw in (dict(), dict(fixed_n=fixed_n),
                   dict(fixed_n=fixed_n, fixed_m=fixed_m)):
            a = milp.build_lp(rtop, 0, 1, 3.0, **kw)
            b = port_milp.build_lp(ptop, 0, 1, 3.0, **kw)
            for field in ("c", "A_ub", "b_ub", "A_eq", "b_eq"):
                np.testing.assert_array_equal(
                    getattr(a, field), getattr(b, field), err_msg=field
                )
        assert e == len(ptop.edge_list(0, 1))


def test_fallback_counts_resolves_and_engines_are_explicit():
    batch, _ = _goal_sweep()
    before = port_batch._resolves.value
    x, fun, ok, n_fb = port_batch.solve_lp_batched_with_fallback(
        *batch, engine="torch", device="cpu"
    )
    assert port_batch._resolves.value - before == n_fb
    assert ok.shape == (4,)
    with pytest.raises(ValueError):
        port_batch.solve_lp_batched_auto(*batch, engine="auto")


def test_power_of_two_buckets():
    assert [_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
