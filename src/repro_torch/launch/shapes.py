"""Assigned input shapes and abstract input specs: the torch twin of the JAX
package's ``launch/shapes.py``.

Shape skips (DESIGN.md §4): ``long_500k`` runs only for sub-quadratic archs
(gemma3 SWA-dominant, mamba2 SSM, zamba2 hybrid); full-attention archs skip
it. Whisper's decode shapes exercise the decoder cache as a shape exercise
(real Whisper caps targets at 448).

The abstract stand-ins are meta-device tensors (the reference's
``jax.ShapeDtypeStruct``s): they carry a shape and a dtype and allocate
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from ..models.config import ModelConfig

# archs allowed to run long_500k (sub-quadratic long-context decode)
LONG_OK = {"gemma3-12b", "mamba2-780m", "zamba2-1.2b"}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str       # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int
    context_parallel: bool = False  # shard KV length instead of batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1, context_parallel=True),
}

# decoder prompt/target length for enc-dec (whisper) train/prefill shapes
ENCDEC_TGT = 448


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if (arch, shape) runs; else a skip reason string."""
    if shape.name == "long_500k" and cfg.name not in LONG_OK:
        return "full-attention arch: 500k-context decode skipped (DESIGN.md §4)"
    return None


def all_cells(cfg: ModelConfig) -> List[ShapeSpec]:
    return [s for s in SHAPES.values() if cell_applicable(cfg, s) is None]


def f(shape, dtype: torch.dtype) -> torch.Tensor:
    """A meta tensor: shape and dtype, no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell."""
    B, S = shape.batch, shape.seq
    cd = cfg.cdtype
    if cfg.family == "encdec":
        if shape.kind in ("train", "prefill"):
            return {"frames": f((B, S, cfg.d_model), cd), "tokens": f((B, ENCDEC_TGT), torch.int32)}
        return {"tokens": f((B, 1), torch.int32)}  # decode: plus the cache
    if cfg.family == "vlm":
        P = cfg.n_patches
        if shape.kind in ("train", "prefill"):
            return {
                "tokens": f((B, S - P), torch.int32),
                "patch_embeds": f((B, P, cfg.d_model), cd),
            }
        return {"tokens": f((B, 1), torch.int32)}
    if shape.kind in ("train", "prefill"):
        return {"tokens": f((B, S), torch.int32)}
    return {"tokens": f((B, 1), torch.int32)}


def cache_specs(model, cfg: ModelConfig, shape: ShapeSpec) -> Any:
    """Abstract KV/state cache for decode shapes: ``model`` on the meta
    device (``build_model(cfg, device="meta")``) allocates nothing."""
    if model.device.type != "meta":
        raise ValueError("cache_specs: pass a model on the meta device "
                         "(build_model(cfg, device='meta')), which allocates nothing")
    return model.empty_cache(shape.batch, shape.seq)
