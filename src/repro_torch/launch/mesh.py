"""Production meshes (the port of ``repro/launch/mesh.py``). Functions, not
module constants: importing this module touches no device or process
group.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
initialised default process group, whose world size must be the product
of the mesh's shape (the reference's ``jax.make_mesh`` fails the same way
without 256 devices). ``device=None`` means the card, as everywhere in
the port; ``device="cpu"`` builds a CPU mesh (gloo), as the tests do.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.device import resolve_device


def _mesh(shape, axes, device=None):
    device_type = resolve_device(device).type
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialised process group of "
            f"{need} ranks"
        )
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(
            f"a {shape} mesh needs {need} ranks, the process group has "
            f"{world}"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) data x model single pod (256 ranks); (2, 16, 16) pod x data
    x model for the 2-pod = 512-rank multi-pod layout."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_mesh_for(n_pods: int, data: int = 16, model: int = 16, *,
                  device=None):
    """Elastic variant: any pod count (1000+ node fleets pick n_pods here)."""
    if n_pods == 1:
        return _mesh((data, model), ("data", "model"), device)
    return _mesh((n_pods, data, model), ("pod", "data", "model"), device)
