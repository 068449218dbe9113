"""Atomic, async checkpointing with exact-resume metadata (the port of
``repro/ckpt/checkpoint.py``).

Layout (one directory per step), the reference's:
    step_00000042/
      MANIFEST.json          leaf shapes/dtypes/checksums, step, extra state
      leaf_00000.npy ...     one file per tree leaf (crc32 over its bytes)
      COMMITTED              written last -> crash-safe atomic commit

Trees are nested dicts of tensors (or numpy arrays), flattened in sorted
key order, recursively: the order of ``jax.tree_util.tree_flatten``. So
a checkpoint written by either package loads in the other. The manifest's
``"treedef"`` describes the tree by its dotted leaf paths (the reference
writes JAX's repr there); loading reads only the leaf count and shapes.
Restore puts each leaf on the device of the matching leaf of ``like``, or,
given ``shardings`` (a tree of ``sharding.specs.NamedSharding``), places
it on that sharding's mesh as a DTensor: a checkpoint taken on one mesh
restores onto another (the elastic rescale path).
A background thread makes saves async (training continues); ``wait()``
drains it. ``CheckpointManager`` keeps the newest k checkpoints and finds
the latest committed one at restart (fault-tolerance restore point).
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.transfer.chunk import checksum
from repro_torch.tree import leaves, tree_leaves, tree_unflatten


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def save_checkpoint(
    directory: str | Path,
    step: int,
    tree,
    *,
    extra: dict | None = None,
) -> Path:
    """Synchronous atomic save. Returns the committed checkpoint path."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {
        "step": int(step),
        "treedef": "dict:" + ",".join(path for path, _ in leaves(tree)),
        "extra": extra or {},
        "leaves": [],
    }
    for i, leaf in enumerate(tree_leaves(tree)):
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc": checksum(arr.tobytes()),
            }
        )
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
    (tmp / "COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _place(arr: np.ndarray, like_leaf, shd):
    """A loaded leaf on ``shd``'s mesh (a DTensor), or without ``shd`` on
    the device of ``like_leaf`` (the CPU where that is not a tensor)."""
    t = torch.from_numpy(arr)
    if shd is not None:
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t.to(shd.mesh.device_type), shd.mesh,
                                 shd.placements())
    device = (like_leaf.device if isinstance(like_leaf, torch.Tensor)
              else "cpu")
    return t.to(device)


def load_checkpoint(path: str | Path, like, *, shardings=None,
                    verify: bool = True):
    """Load into the structure of ``like``; reshard onto ``shardings`` if
    given (module docstring). Every rank of the shardings' mesh must call
    it. Returns (tree, step, extra)."""
    path = Path(path)
    if not (path / "COMMITTED").exists():
        raise FileNotFoundError(f"checkpoint {path} not committed")
    manifest = json.loads((path / "MANIFEST.json").read_text())
    leaves_like = tree_leaves(like)
    shard_leaves = (tree_leaves(shardings) if shardings is not None
                    else [None] * len(leaves_like))
    metas = manifest["leaves"]
    if len(metas) != len(leaves_like):
        raise ValueError(
            f"leaf count mismatch: ckpt {len(metas)} vs "
            f"model {len(leaves_like)}"
        )
    if len(shard_leaves) != len(leaves_like):
        raise ValueError(f"{len(shard_leaves)} shardings for "
                         f"{len(leaves_like)} leaves")
    out = []
    for meta, like_leaf, shd in zip(metas, leaves_like, shard_leaves):
        fname = meta["file"]
        arr = np.load(path / fname)
        if verify and checksum(arr.tobytes()) != meta["crc"]:
            raise IOError(f"checksum mismatch in {fname}")
        want = tuple(getattr(like_leaf, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"{fname}: shape {arr.shape}, want {want}")
        out.append(_place(arr, like_leaf, shd))
    return tree_unflatten(like, out), manifest["step"], manifest["extra"]


def latest_checkpoint(directory: str | Path) -> Path | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    cands = sorted(
        p for p in directory.iterdir()
        if p.name.startswith("step_") and (p / "COMMITTED").exists()
    )
    return cands[-1] if cands else None


class CheckpointManager:
    """Async saves + retention. One in-flight save at a time (a newer save
    waits for the previous to commit, preserving monotone restore points)."""

    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, step: int, tree, *, extra: dict | None = None):
        self.wait()
        # host copies on the caller thread (consistent snapshot), IO async
        tree_host = tree_unflatten(tree, [_host(t) for t in tree_leaves(tree)])

        def run():
            try:
                save_checkpoint(self.directory, step, tree_host, extra=extra)
                self._gc()
            except Exception as ex:  # noqa: BLE001
                self._error = ex

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest(self) -> Path | None:
        return latest_checkpoint(self.directory)

    def restore(self, like, *, shardings=None):
        """(tree, step, extra) from the newest committed checkpoint, or
        (None, 0, {}) when none exists."""
        path = self.latest()
        if path is None:
            return None, 0, {}
        return load_checkpoint(path, like, shardings=shardings)

    def _gc(self):
        cands = sorted(
            p for p in self.directory.iterdir() if p.name.startswith("step_")
        )
        for p in cands[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)
