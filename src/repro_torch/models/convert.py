"""Parameters across the two packages.

``params_from_jax`` turns the JAX package's params pytree, fetched to the
host as a nested dict of numpy arrays (``jax.device_get``), into the
port's nested dict of tensors: same names, shapes and dtypes (bfloat16
leaves arrive as ``ml_dtypes`` arrays and are carried over by their 16-bit
patterns). ``load_params`` puts such a tree into a model, replacing its
parameters. The tests carry weights across with them; checkpoints carry
them across on disk.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A tensor with ``a``'s values; bfloat16 (``ml_dtypes``) by its bits."""
    a = np.array(a, copy=True, order="C")  # owned and writable
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Any) -> Any:
    """Nested dict of numpy arrays -> nested dict of CPU tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))


def load_params(model: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Replace every parameter of ``model`` by the leaf of ``tree`` with the
    same path, moved to the model's device as needed. Shapes and dtypes must
    match and every parameter must be given."""
    want = model.param_tree()
    device = model.device if model.device.type != "meta" else None

    def put(module: torch.nn.Module, name: str, old: torch.Tensor, new: Any, path: str):
        new = new if isinstance(new, torch.Tensor) else tensor_from_numpy(np.asarray(new))
        if tuple(new.shape) != tuple(old.shape) or new.dtype != old.dtype:
            raise ValueError(f"{path}: given {new.dtype} {tuple(new.shape)}, model has "
                             f"{old.dtype} {tuple(old.shape)}")
        if device is not None:
            new = new.to(device)
        setattr(module, name, torch.nn.Parameter(new, requires_grad=False))

    def walk(module: torch.nn.Module, want_t: Dict[str, Any], got: Dict[str, Any], prefix: str):
        if set(want_t) != set(got):
            raise ValueError(f"{prefix or 'params'}: keys {sorted(got)} != {sorted(want_t)}")
        for key, old in want_t.items():
            sub = getattr(module, key)
            if isinstance(old, dict):
                walk(sub, old, got[key], f"{prefix}{key}.")
            else:
                put(module, key, old, got[key], prefix + key)

    walk(model, want, tree, "")
    model.params_changed()
