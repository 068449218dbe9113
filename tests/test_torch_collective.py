"""The port's planner-ordered pod ring against the reference's.

The reference's ``ring_allreduce_tree`` runs once, in a subprocess with 8
host devices (``--xla_force_host_platform_device_count=8``), under
``jax.jit(jax.shard_map(..., check_vma=False))`` on a ("pod",) mesh of 2,
3 and 4 devices, compressed and not. The port runs the same seeded
inputs on 2, 3 and 4 gloo CPU ranks (one spawn per world size, every case
of that size in it, the three at once) through its public path:
``make_mesh_for(n, 1, 1)`` and ``make_pod_gradient_reducer`` over a
throughput grid whose planner ring is not ``0..n-1``. Held:

  * uncompressed: every rank equals the reference's bit for bit (the
    mean is XLA's product with the f32 reciprocal of n) and is within
    1e-5 of the numpy mean;
  * compressed: every rank within one quantization step of the
    reference's (the largest block's scale, over n): XLA computes the
    reference's scale ``absmax / 127`` as a reciprocal product, the
    port's kernels and their plain version divide, so a scale may sit one
    ulp apart; and the port's two 2-pod ranks are bit-identical;
  * ``choose_ring_order`` equals the reference's on random grids.
"""

from __future__ import annotations

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 3, 4)
SHAPES = {"a": (6, 333), "b": (1000,), "c": (7,), "d": (3, 4, 300)}
MEAN_TOL = 1e-5


RINGS = {2: [0, 1], 3: [0, 2, 1], 4: [0, 2, 1, 3]}


def grid(n: int) -> np.ndarray:
    """A seeded symmetric pod throughput grid (Gbps) whose fast links
    close the ring ``RINGS[n]``, each hop slower than the one before."""
    g = np.random.default_rng(100 + n).uniform(1.0, 2.0, (n, n))
    ring = RINGS[n]
    for i in range(n):
        a, b = ring[i], ring[(i + 1) % n]
        g[a, b] += 10.0 + n - i
        g[b, a] += 10.0 + n - i
    return np.minimum(g, g.T)


def inputs(n: int) -> dict:
    """Each leaf stacked over the n ranks: [n, *shape] f32."""
    rng = np.random.default_rng(n)
    return {k: rng.standard_normal((n, *s), dtype=np.float32)
            for k, s in SHAPES.items()}


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "src")
import jax, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.transfer.collective import choose_ring_order, ring_allreduce_tree

data = np.load(sys.argv[1])
out = {}
for n in (2, 3, 4):
    xs = {k[2:]: data[k] for k in data.files if k.startswith(f"{n}_")}
    order = choose_ring_order(data[f"grid{n}"])
    mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
    for comp in (0, 1):
        def body(t, order=order, comp=comp):
            t = jax.tree.map(lambda a: a[0], t)
            r = ring_allreduce_tree(t, "pod", order, compress_wire=bool(comp))
            return jax.tree.map(lambda a: a[None], r)

        f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("pod"),
                                  out_specs=P("pod"), check_vma=False))
        for k, v in f(xs).items():
            out[f"{n}_{comp}_{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def _port_ranks(rank, world, xs):
    """One rank: the reducer's output for both wire modes, as numpy."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.transfer.collective import make_pod_gradient_reducer

    mesh = make_mesh_for(world, 1, 1, device="cpu")
    tree = {k: torch.from_numpy(v[rank].copy()) for k, v in xs.items()}
    out = {}
    for comp in (False, True):
        reduce = make_pod_gradient_reducer(mesh, pod_tput=grid(world),
                                           compress_wire=comp)
        out[comp] = {k: t.numpy() for k, t in reduce(tree).items()}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"ref": {(n, comp): {leaf: [n, ...]}}, "port": {n: [rank results]}};
    the reference's subprocess runs while the port's ranks do."""
    from repro_torch.launch.ranks import spawn_ranks

    tmp = tmp_path_factory.mktemp("ring")
    data = {f"{n}_{k}": v for n in WORLDS for k, v in inputs(n).items()}
    data.update({f"grid{n}": grid(n) for n in WORLDS})
    np.savez(tmp / "in.npz", **data)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
         str(tmp / "ref.npz")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    port: dict = {}

    def run(n):
        port[n] = spawn_ranks(_port_ranks, n, (inputs(n),), workdir=tmp)

    worlds = [threading.Thread(target=run, args=(n,)) for n in WORLDS]
    try:
        for t in worlds:
            t.start()
        _, err = ref.communicate(timeout=600)
    finally:
        for t in worlds:
            t.join()
        ref.kill()
    assert sorted(port) == list(WORLDS), "a world's ranks failed"
    assert ref.returncode == 0, err[-3000:]
    got = np.load(tmp / "ref.npz")
    ref_out = {}
    for key in got.files:
        n, comp, leaf = key.split("_")
        ref_out.setdefault((int(n), bool(int(comp))), {})[leaf] = got[key]
    return {"ref": ref_out, "port": port}


def _step(n: int, leaf: str) -> float:
    """One quantization step of the leaf's largest block, over n: no sum
    of the n inputs exceeds sum |x|, whose int8 step is that over 127."""
    return float(np.abs(inputs(n)[leaf]).sum(0).max()) / 127.0 / n


@pytest.mark.parametrize("n", WORLDS)
def test_uncompressed_equals_reference_bitwise(results, n):
    ref = results["ref"][(n, False)]
    for rank, out in enumerate(results["port"][n]):
        for k in SHAPES:
            np.testing.assert_array_equal(out[False][k], ref[k][rank],
                                          err_msg=f"rank {rank} leaf {k}")


@pytest.mark.parametrize("n", WORLDS)
def test_uncompressed_is_the_mean(results, n):
    xs = inputs(n)
    for out in results["port"][n]:
        for k in SHAPES:
            np.testing.assert_allclose(out[False][k], xs[k].mean(0),
                                       rtol=0, atol=MEAN_TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_compressed_within_one_quantization_step_of_reference(results, n):
    ref = results["ref"][(n, True)]
    for rank, out in enumerate(results["port"][n]):
        for k in SHAPES:
            gap = float(np.abs(out[True][k] - ref[k][rank]).max())
            assert gap <= _step(n, k), (rank, k, gap, _step(n, k))


@pytest.mark.parametrize("n", WORLDS)
def test_compressed_is_near_the_mean(results, n):
    """Each hop adds at most half a step of its block's scale: 2(n-1)
    hops at most, before the mean divides by n."""
    xs = inputs(n)
    for out in results["port"][n]:
        for k in SHAPES:
            gap = float(np.abs(out[True][k] - xs[k].mean(0)).max())
            assert gap <= (n - 1) * _step(n, k), (k, gap)


def test_two_pod_compressed_ranks_are_bit_identical(results):
    a, b = results["port"][2]
    for k in SHAPES:
        np.testing.assert_array_equal(a[True][k], b[True][k])


@pytest.mark.parametrize("n", WORLDS)
def test_ring_orders_are_the_planners(n):
    """The grids give rings other than 0..n-1 where n > 2, so the tests
    above cover a planner-ordered ring."""
    from repro.transfer.collective import choose_ring_order as ref_order
    from repro_torch.transfer.collective import choose_ring_order

    order = choose_ring_order(grid(n))
    assert order == ref_order(grid(n)) == RINGS[n]


@pytest.mark.parametrize("seed", range(6))
def test_choose_ring_order_matches_reference(seed):
    from repro.transfer.collective import choose_ring_order as ref_order
    from repro_torch.transfer.collective import choose_ring_order

    rng = np.random.default_rng(seed)
    for n in range(1, 9):
        g = rng.uniform(0.5, 50.0, (n, n))
        if seed % 2:
            g = np.round(g)  # ties: both keep the lower index
        assert choose_ring_order(g) == ref_order(g), (seed, n)


def test_reducer_is_none_without_a_pod_axis():
    from repro_torch.transfer.collective import make_pod_gradient_reducer

    class _FakeMesh:
        axis_names = ("data", "model")
        devices = np.empty((16, 16))

    assert make_pod_gradient_reducer(_FakeMesh()) is None
