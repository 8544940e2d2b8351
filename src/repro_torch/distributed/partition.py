"""Parameter partition specs: param-tree path -> spec, the torch twin of the
JAX package's ``distributed/partition.py`` with the same tables.

Strategy (DESIGN.md §3):

* dense archs — Megatron TP over ``model`` (attention fused-head dims, MLP
  d_ff, vocab), params replicated over ``data`` (their optimizer state too);
* MoE giants — TP over ``model`` **plus** FSDP over ``data`` on the d_model
  axis (ZeRO-3), each layer's weights gathered on entry, keeping per-device
  bytes ≈ params/(16·16);
* every spec is divisibility-checked against the mesh and falls back to
  less-sharded alternatives, so awkward dims (qwen's 40 heads) degrade
  gracefully instead of failing.

Leading scan (layer-stack) axes are never sharded.

A spec is a tuple of entries (``sharding.Spec``); a tree is the model's
``param_tree()`` (tensors, meta tensors or ``DTensor``s: only shapes are
read), whose paths are the reference's (``checkpoint/store.py`` keeps the
leaf names equal). ``mesh`` is a ``DeviceMesh`` or an ``{axis: size}``
dict, so the production tables build with no devices.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Sequence, Tuple

from ..models.config import ModelConfig
from .sharding import Spec, axis_size, mesh_shape


def _fits(shape: Tuple[int, ...], spec: Sequence, mesh_shape: Dict[str, int]) -> bool:
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        if dim % axis_size(mesh_shape, axes) != 0:
            return False
    return True


def _choose(shape, candidates, mesh_shape) -> Spec:
    """First candidate spec that divides evenly; final fallback replicated."""
    for cand in candidates:
        cand = tuple(cand) + (None,) * (len(shape) - len(cand))
        if _fits(shape, cand, mesh_shape):
            return cand
    return (None,) * len(shape)


# Rules: (path regex, candidate specs for the *trailing* named dims).
# 'F' = fsdp axis placeholder (resolved to 'data' for fsdp trees, else None).
def _rules(fsdp: bool):
    F = "data" if fsdp else None
    return [
        # embeddings / heads
        (r"embed$", [("model", F), ("model", None), (None, None)]),
        (r"lm_head$", [(F, "model"), (None, "model"), (None, None)]),
        (r"(enc_pos|dec_pos)$", [(None, "model"), (None, None)]),
        (r"mm_proj$", [(F, "model"), (None, "model")]),
        # attention (d, H, hd) / (H, hd, d)
        (r"attn/w[qkv]$", [(F, "model", None), (None, "model", None), (None, None, "model"), (F, None, None)]),
        (r"attn/wo$", [("model", None, F), ("model", None, None), (None, "model", None), (None, None, F)]),
        (r"attn/b[qkv]$", [("model", None), (None, None)]),
        (r"attn/bo$", [(None,)]),
        # MLA
        (r"attn/wq_a$", [(F, "model"), (None, "model")]),
        (r"attn/wq_b$", [(None, "model", None), ("model", None, None)]),
        (r"attn/wkv_a$", [(F, "model"), (None, "model"), (F, None)]),
        (r"attn/wkv_b$", [(None, "model", None)]),
        # MLP (d, ff) / (ff, d)
        (r"(mlp|ffn)/w_(up|gate)$", [(F, "model"), (None, "model")]),
        (r"(mlp|ffn)/w_down$", [("model", F), ("model", None)]),
        (r"(mlp|ffn)/w1$", [(F, "model"), (None, "model")]),
        (r"(mlp|ffn)/w2$", [("model", F), ("model", None)]),
        # MoE
        (r"ffn/router$", [(F, "model"), (None, "model"), (None, None)]),
        (r"ffn/w_(gate|up)$", [("model", F, None), ("model", None, None)]),  # (E, d, ffe)
        (r"ffn/shared_(gate|up)$", [(F, "model"), (None, "model")]),
        (r"ffn/shared_down$", [("model", F), ("model", None)]),
        # Mamba2
        (r"ssm/w_(z|x)$", [(F, "model"), (None, "model")]),
        (r"ssm/w_(B|C|dt)$", [(F, "model"), (None, "model"), (F, None), (None, None)]),
        (r"ssm/conv_._w$", [("model", None), (None, None)]),
        (r"ssm/conv_._b$", [("model",), (None,)]),
        (r"ssm/norm$", [("model",), (None,)]),
        (r"ssm/out_proj$", [("model", F), ("model", None)]),
        # zamba shared block
        (r"shared/out_proj$", [("model", F), ("model", None)]),
        (r"shared/mlp/w_(up|gate)$", [(F, "model"), (None, "model")]),
        (r"shared/mlp/w_down$", [("model", F), ("model", None)]),
        # mtp projection
        (r"mtp/proj$", [(F, "model"), (None, "model")]),
        # norms & 1-d leftovers: replicated
        (r".*", [()]),
    ]


def is_moment(x: Any) -> bool:
    """A quantized moment: ``{"q", "scale"}``."""
    return isinstance(x, dict) and set(x.keys()) == {"q", "scale"}


def tree_map_with_path(fn, tree: Any, *more: Any, path: str = "", is_leaf=None) -> Any:
    """``fn(path, leaf, *more_leaves)`` over nested dicts; ``path`` joins the
    keys with ``/`` as the reference's ``_path_str`` does."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map_with_path(fn, v, *(m[k] for m in more),
                                      path=f"{path}/{k}" if path else str(k), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(path, tree, *more)


def param_specs(
    params_shape: Any,
    cfg: ModelConfig,
    mesh: Any,
    *,
    n_scan_dims: int = 1,
    strategy: str = "tp",
) -> Any:
    """A spec tree matching ``params_shape`` (the model's ``param_tree()``,
    meta tensors will do).

    strategy='tp' (default): Megatron TP over 'model' (+FSDP for MoE giants).
    strategy='dp': pure data parallelism — params REPLICATED (batch shards
    over both mesh axes); pair with ``zero1_moment_specs`` so optimizer
    state shards ZeRO-1 style. Wins for small models where TP's activation
    all-reduces dominate (the reference's olmo hillclimb).
    """
    shape_of_mesh = mesh_shape(mesh)
    if strategy == "dp":
        return tree_map_with_path(lambda _, l: (None,) * len(l.shape), params_shape)
    fsdp = bool(cfg.moe and cfg.moe.n_experts) and cfg.param_dtype != "float32"
    rules = _rules(fsdp)

    # layer stacks have a leading scan dim; detect by path prefix
    stack_prefixes = ("dense_layers", "moe_layers", "layers", "enc_layers", "dec_layers")

    def spec_of(ps, leaf):
        shape = tuple(leaf.shape)
        lead = 1 if ps.startswith(stack_prefixes) else 0
        trail = shape[lead:]
        for pat, candidates in rules:
            if re.search(pat, ps):
                sp = _choose(trail, candidates, shape_of_mesh)
                return (None,) * lead + tuple(sp)
        return (None,) * len(shape)

    return tree_map_with_path(spec_of, params_shape)


def opt_state_specs(opt_state_shape: Any, pspecs: Any) -> Any:
    """Optimizer state shards like its parameter. Quantized moments ({"q",
    "scale"}) inherit the param spec ("q" same rank; "scale" drops the last
    dim's sharding)."""

    def like(param_spec: Spec, leaf_shape) -> Spec:
        sp = tuple(param_spec)
        rank = len(leaf_shape.shape)
        if rank == len(sp):
            return sp
        if rank == len(sp) + 1:  # blockwise scale: (..., nblocks) - keep prefix
            return (sp[:-1] + (None, None))[:rank]
        if rank < len(sp):
            return sp[:rank]
        return sp + (None,) * (rank - len(sp))

    def map_state(_, state, specs):
        if is_moment(state):
            sp = tuple(specs)
            # scale has shape param.shape[:-1] + (nblocks,): keep the prefix
            # sharding, never shard the block-count dim
            scale_spec = (sp[:-1] + (None,)) if sp else (None,)
            return {"q": like(specs, state["q"]), "scale": scale_spec}
        if isinstance(state, dict):
            raise TypeError("unexpected dict in moment tree")
        return like(specs, state)

    m = tree_map_with_path(map_state, opt_state_shape["m"], pspecs, is_leaf=is_moment)
    v = tree_map_with_path(map_state, opt_state_shape["v"], pspecs, is_leaf=is_moment)
    return {"step": (), "m": m, "v": v}


def zero1_moment_specs(opt_state_shape: Any, mesh: Any) -> Any:
    """ZeRO-1: shard each moment leaf on its largest evenly-divisible dim
    (layer-stack dims split over 'data', vocab-sized dims over 'model');
    params stay replicated — the step reduce-scatters the gradients to this
    layout and all-gathers the updated params."""
    shape_of_mesh = mesh_shape(mesh)

    def spec(leaf) -> Spec:
        shape = tuple(leaf.shape)
        for axes in (("data",), ("model",), ("data", "model")):
            n = 1
            for a in axes:
                n *= shape_of_mesh.get(a, 1)
            for i, dim in enumerate(shape):
                if dim % n == 0 and dim >= n:
                    return tuple(axes if j == i else None for j in range(len(shape)))
        return (None,) * len(shape)

    def map_state(_, state):
        if is_moment(state):
            return {"q": spec(state["q"]), "scale": spec(state["scale"])}
        return spec(state)

    return {
        "step": (),
        "m": tree_map_with_path(map_state, opt_state_shape["m"], is_leaf=is_moment),
        "v": tree_map_with_path(map_state, opt_state_shape["v"], is_leaf=is_moment),
    }
