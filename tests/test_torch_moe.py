"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe``, on the CPU.

Reduced Qwen3-MoE (8 experts, top-2, d_model 64) with the reference's
parameters converted leaf for leaf, and the same numpy input, through
``moe_mlp`` with ``moe_shard_dispatch`` and ``moe_psum_combine`` each
False and True, in f32 and bf16, at the config's capacity factor (1.25)
and at 0.5, where capacity drops assignments (asserted).

Routing is compared first: the port's top-k experts (recorded by
``moe.record_routing``) against ``jax.lax.top_k`` of the reference's
router probabilities, and the port's kept assignments against a plain
numpy replay of the reference's dispatch rule (stable sort by expert,
position in the expert, ``pos < capacity``). A token whose routing
differs must sit at a near-tie (its k-th and (k+1)-th probabilities within
1e-5, relative); such tokens are left out of the output check and counted,
and may not pass 1% of the tokens. Outputs then: f32 within 1e-4 (the
frameworks' summation orders), bf16 within 2e-2 (the reference's own bf16
tolerance, ``tests/test_kernels.py:45``): JAX rounds each elementwise op
of the gated activation to bf16 where torch rounds once. Gradients of a
weighted sum against ``jax.grad``, f32, 1e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, MoEConfig, reduced
from repro.models import moe as j_moe
from repro.models.params import materialize
from repro.sharding.specs import ShardingRules as JRules
from repro_torch import convert
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import MoEConfig as TMoEConfig
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import moe
from repro_torch.sharding.specs import ShardingRules
from test_torch_cases import one_thread  # noqa: F401

J_RULES = JRules(batch=None, fsdp=None, tp=None)
RULES = ShardingRules(batch=None, fsdp=None, tp=None)
B, S = 2, 32
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
NEAR_TIE = 1e-5  # relative gap between the k-th and (k+1)-th probability
MAX_TIES = 0.01  # share of tokens that near-ties may exclude


def _cfgs(dtype: str, cf: float, shard: bool, psum: bool):
    moe_cfg = dict(num_experts=8, top_k=2, d_ff_expert=64,
                   capacity_factor=cf)
    kw = dict(dtype=dtype, moe_shard_dispatch=shard, moe_psum_combine=psum)
    j = dataclasses.replace(reduced(ARCHS["qwen3-moe-30b-a3b"]),
                            moe=MoEConfig(**moe_cfg), **kw)
    t = dataclasses.replace(t_reduced(T_ARCHS["qwen3-moe-30b-a3b"]),
                            moe=TMoEConfig(**moe_cfg), **kw)
    return j, t


def _inputs(jcfg):
    params = materialize(j_moe.moe_defs(jcfg), jax.random.PRNGKey(4))
    x = np.random.default_rng(9).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return params, x


def _reference_routing(jcfg, params, x):
    """The reference's router on x: top-k experts [T, k], the top k+1
    probabilities, and the kept assignments by its dispatch rule."""
    dt = jnp.dtype(jcfg.dtype)
    xt = jnp.asarray(x, dt).reshape(-1, jcfg.d_model)
    logits = jnp.einsum("td,de->te", xt, params["router"].astype(dt),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    m = jcfg.moe
    top, eidx = jax.lax.top_k(probs, m.top_k + 1)
    eidx = np.asarray(eidx)[:, :m.top_k]
    return eidx, np.asarray(top), _kept(eidx, j_moe.capacity(jcfg, len(xt)))


def _kept(eidx: np.ndarray, cap: int) -> np.ndarray:
    """Plain replay of the dispatch rule: token-major assignments sorted
    stably by expert; an assignment's position in its expert < cap."""
    fe = eidx.reshape(-1)
    order = np.argsort(fe, kind="stable")
    pos = np.empty_like(fe)
    for e in np.unique(fe):
        idx = order[fe[order] == e]
        pos[idx] = np.arange(len(idx))
    return (pos < cap).reshape(eidx.shape)


def _near_ties(probs: np.ndarray, k: int) -> np.ndarray:
    return (probs[:, k - 1] - probs[:, k]) <= NEAR_TIE * probs[:, k - 1]


def _check_routing(rec: dict, want_e, want_p, want_keep, k: int):
    """Routing equal but at near-ties; returns the mask of tokens whose
    routing differs (to leave out of the output check)."""
    got_e = np.sort(rec["experts"].numpy(), -1)
    differ = np.any(got_e != np.sort(want_e, -1), -1)
    assert np.all(_near_ties(want_p, k)[differ]), "routing differs off a tie"
    assert differ.mean() <= MAX_TIES, f"{differ.sum()} near-tie tokens"
    same = ~differ
    np.testing.assert_array_equal(rec["keep"].numpy()[same], want_keep[same])
    np.testing.assert_allclose(rec["probs"].numpy()[same], want_p[same],
                               rtol=1e-5, atol=1e-7)
    return differ


CASES = [(dt, cf, shard, psum)
         for dt in ("float32", "bfloat16") for cf in (1.25, 0.5)
         for shard in (False, True) for psum in (False, True)]


@pytest.mark.parametrize("dtype,cf,shard,psum", CASES)
def test_moe_mlp_matches_reference(dtype, cf, shard, psum):
    jcfg, tcfg = _cfgs(dtype, cf, shard, psum)
    params, x = _inputs(jcfg)
    tparams = convert.params_from_state(convert.params_state(params), "cpu")
    want = np.asarray(j_moe.moe_mlp(jcfg, J_RULES, params,
                                    jnp.asarray(x, jnp.dtype(dtype))),
                      np.float32)
    with moe.record_routing() as recs:
        got = moe.moe_mlp(tcfg, RULES, tparams,
                          torch.tensor(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and len(recs) == 1
    want_e, want_p, want_keep = _reference_routing(jcfg, params, x)
    differ = _check_routing(recs[0], want_e, want_p, want_keep,
                            jcfg.moe.top_k)
    if cf < 1:
        assert not want_keep.all(), "the small capacity dropped nothing"
    got = got.float().numpy().reshape(B * S, -1)
    want = want.reshape(B * S, -1)
    tol = TOL[dtype]
    np.testing.assert_allclose(got[~differ], want[~differ], atol=tol,
                               rtol=tol)


def test_psum_combine_loses_the_last_slot_of_an_overflowing_expert():
    """With drops, the psum combine differs from the gather combine only
    in the tokens kept in slot C-1 of an overflowing expert: the
    reference's owner scatter hands that slot to the expert's last
    (dropped) assignment. Both packages agree on which tokens change."""
    outs = {}
    for psum in (False, True):
        jcfg, tcfg = _cfgs("float32", 0.5, True, psum)
        params, x = _inputs(jcfg)
        tparams = convert.params_from_state(convert.params_state(params),
                                            "cpu")
        outs[psum] = (
            np.asarray(j_moe.moe_mlp(jcfg, J_RULES, params, jnp.asarray(x))),
            moe.moe_mlp(tcfg, RULES, tparams, torch.tensor(x)).numpy())
    j_moved = np.any(outs[True][0] != outs[False][0], -1)
    t_moved = np.any(np.abs(outs[True][1] - outs[False][1]) > 1e-6, -1)
    assert j_moved.any()
    np.testing.assert_array_equal(t_moved, j_moved)


@pytest.mark.parametrize("shard", [False, True])
def test_moe_mlp_gradients_match_jax(shard):
    """Gradients of sum(moe_mlp(x) * w) for the router, the three expert
    weights and x, f32, with drops (capacity factor 0.5)."""
    jcfg, tcfg = _cfgs("float32", 0.5, shard, shard)
    params, x = _inputs(jcfg)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def j_obj(p, xx):
        return jnp.sum(j_moe.moe_mlp(jcfg, J_RULES, p, xx) * w)

    jg_p, jg_x = jax.grad(j_obj, argnums=(0, 1))(params, jnp.asarray(x))
    tparams = {k: v.requires_grad_(True) for k, v in convert.params_from_state(
        convert.params_state(params), "cpu").items()}
    tx = torch.tensor(x, requires_grad=True)
    torch.sum(moe.moe_mlp(tcfg, RULES, tparams, tx)
              * torch.tensor(w)).backward()
    for name, g in jg_p.items():
        np.testing.assert_allclose(tparams[name].grad.numpy(), np.asarray(g),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), atol=1e-4,
                               rtol=1e-4)


def test_capacity_and_defs_match_reference():
    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x22b"):
        for shard in (False, True):
            j = dataclasses.replace(ARCHS[arch], moe_shard_dispatch=shard)
            t = dataclasses.replace(T_ARCHS[arch], moe_shard_dispatch=shard)
            jd, td = j_moe.moe_defs(j, (3,)), moe.moe_defs(t, (3,))
            assert sorted(jd) == sorted(td)
            for k in jd:
                assert (jd[k].shape, jd[k].logical, jd[k].fan_in) == (
                    td[k].shape, td[k].logical, td[k].fan_in)
        for tokens in (4, 512, 16_384):
            assert moe.capacity(T_ARCHS[arch], tokens) == j_moe.capacity(
                ARCHS[arch], tokens)
    assert moe.capacity(T_ARCHS["qwen3-moe-30b-a3b"], 16_384) == 1_280


def test_stable_top_k_breaks_ties_toward_the_lower_expert():
    """Router logits with exact ties: the port picks the experts
    ``jax.lax.top_k`` picks."""
    _, tcfg = _cfgs("float32", 1.25, False, False)
    d, e = tcfg.d_model, tcfg.moe.num_experts
    router = torch.zeros(d, e)
    router[0] = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0, 0.0, 2.0, 1.0])
    x = torch.zeros(1, 4, d)
    x[..., 0] = 1.0
    p = {"router": router, "wi": torch.zeros(e, d, 64),
         "wg": torch.zeros(e, d, 64), "wo": torch.zeros(e, 64, d)}
    with moe.record_routing() as recs:
        moe.moe_mlp(tcfg, RULES, p, x)
    want = np.asarray(jax.lax.top_k(
        jax.nn.softmax(jnp.asarray(router[0].numpy())), 2)[1])
    np.testing.assert_array_equal(recs[0]["experts"].numpy()[0], want)
    np.testing.assert_array_equal(want, [1, 2])


MESH_REFERENCE = """
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS, MoEConfig, reduced
from repro.launch.mesh import make_mesh_for
from repro.models import moe
from repro.sharding.specs import ShardingRules, set_mesh

state, x, moe_cfg, kw = pickle.load(open(sys.argv[1], "rb"))
cfg = dataclasses.replace(reduced(ARCHS["qwen3-moe-30b-a3b"]),
                          moe=MoEConfig(**moe_cfg), **kw)
params = {k: jnp.asarray(v) for k, v in state.items()}
rules = ShardingRules(batch=("data",))
mesh = make_mesh_for(1, 2, 1)
set_mesh(mesh)
with mesh:
    y = jax.jit(lambda p, v: moe.moe_mlp(cfg, rules, p, v))(
        params, jnp.asarray(x))
pickle.dump((moe._batch_shards(rules), np.asarray(y)),
            open(sys.argv[2], "wb"))
"""


def test_shard_dispatch_counts_the_mesh_batch_shards(tmp_path):
    """``moe_shard_dispatch`` on a 2-way ``data`` mesh: the port counts 2
    shards as the reference does, capacity is per shard, drops equal the
    reference's dispatch rule replayed on each shard, and the output
    equals the reference's on a mesh of 2 host devices (f32, 1e-4). It
    differs from the output without a mesh, so the shard count shows."""
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.sharding.specs import set_mesh

    moe_cfg = dict(num_experts=8, top_k=2, d_ff_expert=64,
                   capacity_factor=0.5)
    kw = dict(dtype="float32", moe_shard_dispatch=True,
              moe_psum_combine=False)
    jcfg, tcfg = _cfgs("float32", 0.5, True, False)
    params, x = _inputs(jcfg)
    state = convert.params_state(params)
    src, dst = tmp_path / "in.pkl", tmp_path / "out.pkl"
    src.write_bytes(pickle.dumps((state, x, moe_cfg, kw)))
    repo = Path(__file__).resolve().parents[1]
    ref = subprocess.run(
        [sys.executable, "-c", MESH_REFERENCE, str(src), str(dst)],
        cwd=repo, capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-3000:]
    j_shards, want = pickle.loads(dst.read_bytes())

    class _Mesh:  # make_mesh_for(1, 2, 1)'s axis names and shape
        axis_names = ("data", "model")
        devices = np.empty((2, 1))

    rules = ShardingRules(batch=("data",))
    tparams = convert.params_from_state(state, "cpu")
    set_mesh(_Mesh())
    try:
        shards = moe._batch_shards(rules)
        with moe.record_routing() as recs:
            got = moe.moe_mlp(tcfg, rules, tparams, torch.tensor(x))
    finally:
        set_mesh(None)
    alone = moe.moe_mlp(tcfg, rules, tparams, torch.tensor(x))
    assert shards == j_shards == 2
    eidx, _, _ = _reference_routing(jcfg, params, x)
    t_loc = B * S // shards
    cap = j_moe.capacity(jcfg, t_loc)
    want_keep = np.concatenate([_kept(eidx[i * t_loc:(i + 1) * t_loc], cap)
                                for i in range(shards)])
    keep = recs[0]["keep"].numpy()
    assert (~keep).sum() == (~want_keep).sum() > 0
    np.testing.assert_array_equal(keep, want_keep)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert np.abs(alone.numpy() - want).max() > 1e-2
