"""The port's checkpoints against the reference package's, across the two.

Both packages write the same layout (``step_XXXXXXXX/``, ``MANIFEST.json``,
``leaf_%05d.npy``, crc32 checksums, ``COMMITTED``) and flatten a tree of
dicts in sorted key order, so a trainer state saved by the reference
loads in the port and one saved by the port loads in
``repro.ckpt.load_checkpoint``, leaves bit for bit; a corrupted leaf
fails its checksum in either. The reference's own checkpoint tests
(round trip, retention, latest) are held on the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import load_checkpoint as j_load
from repro.ckpt.checkpoint import save_checkpoint as j_save
from repro.configs import ARCHS, reduced
from repro.models import init_params as j_init
from repro_torch import models
from repro_torch.ckpt import (
    CheckpointManager,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduced as t_reduced
from repro_torch.train import init_opt_state
from repro_torch.tree import tree_leaves
from test_torch_cases import one_thread  # noqa: F401


def _j_state():
    params = j_init(reduced(ARCHS["smollm-135m"]), jax.random.PRNGKey(0))
    # moments and a step that are not zeros, so the leaf order shows
    opt = {"m": jax.tree.map(lambda t: t * 0.5, params),
           "v": jax.tree.map(lambda t: t * t, params),
           "step": jnp.asarray(7, jnp.int32)}
    return {"params": params, "opt": opt}


def _t_state(seed: int = 0):
    cfg = t_reduced(T_ARCHS["smollm-135m"])
    params = models.init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
    opt = init_opt_state(params)
    opt["m"] = {k: v for k, v in params.items()}
    opt["step"] = torch.tensor(11, dtype=torch.int32)
    return {"params": params, "opt": opt}


def _corrupt(path):
    victim = sorted(path.glob("leaf_*.npy"))[3]
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0xFF
    victim.write_bytes(bytes(data))


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    tree = _j_state()
    path = j_save(tmp_path, 42, tree, extra={"pipeline": {"next_shard": 3,
                                                          "epoch": 0}})
    like = _t_state()
    got, step, extra = load_checkpoint(path, like)
    assert step == 42 and extra == {"pipeline": {"next_shard": 3, "epoch": 0}}
    want = jax.tree.leaves(tree)
    assert len(tree_leaves(got)) == len(want)
    for g, w in zip(tree_leaves(got), want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.numpy().dtype == np.asarray(w).dtype
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) \
        == 7
    _corrupt(path)
    with pytest.raises(IOError):
        load_checkpoint(path, like)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    tree = _t_state(seed=3)
    path = save_checkpoint(tmp_path, 9, tree, extra={"k": 1})
    like = _j_state()
    got, step, extra = j_load(path, like)
    assert step == 9 and extra == {"k": 1}
    for g, w in zip(jax.tree.leaves(got), tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    _corrupt(path)
    with pytest.raises(IOError):
        j_load(path, like)


def test_round_trip_and_checksum(tmp_path):
    tree = _t_state()
    path = save_checkpoint(tmp_path, 7, tree, extra={"k": 1})
    restored, step, extra = load_checkpoint(path, tree)
    assert step == 7 and extra == {"k": 1}
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert torch.equal(a, b)
    _corrupt(path)
    with pytest.raises(IOError):
        load_checkpoint(path, tree)
    with pytest.raises(ValueError):
        load_checkpoint(path, {"params": tree["params"]})


def test_manager_retention_latest_and_snapshot(tmp_path):
    """Retention and latest as in the reference; the async save copies
    the leaves on the caller's thread, so an in-place update right after
    ``save_async`` does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, keep=2)
    w = torch.arange(8.0)
    for s in (1, 2, 3):
        mgr.save_async(s, {"w": w})
        w.add_(100.0)  # the trainer's in-place optimizer step
        mgr.wait()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_00000002", "step_00000003"]
    assert latest_checkpoint(tmp_path).name == "step_00000003"
    restored, step, _ = mgr.restore({"w": w})
    assert step == 3
    assert torch.equal(restored["w"], torch.arange(8.0) + 200.0)
    assert CheckpointManager(tmp_path / "none").restore({"w": w}) == (
        None, 0, {})


def test_uncommitted_checkpoint_is_not_loaded(tmp_path):
    path = save_checkpoint(tmp_path, 1, {"w": torch.ones(3)})
    (path / "COMMITTED").unlink()
    assert latest_checkpoint(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(path, {"w": torch.ones(3)})
