"""Production mesh definitions: the torch twin of the JAX package's
``launch/mesh.py``. Functions, not constants: importing this module never
touches the process group.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, one process a device (NCCL on the card, gloo on the CPU),
which the caller starts first (``torch.distributed.init_process_group``
with an address, world size and rank of its own).
"""

from __future__ import annotations

from typing import Tuple

from ..distributed.sharding import mesh_shape


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the default
    group, whose world size must be the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise RuntimeError(f"a {shape} mesh over {names} needs a process group of {n} "
                           f"ranks, one a device; have {have}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: 256 devices (16 data x 16 model). Multi-pod: 2 pods = 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda"):
    """The whole world over one ``data`` axis (tests / examples)."""
    import torch.distributed as dist

    return make_mesh((dist.get_world_size(),), ("data",), device_type)


#: ``{axis: size}`` of a ``DeviceMesh`` (or of a dict, as given)
mesh_shape_dict = mesh_shape
