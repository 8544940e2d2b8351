"""Sharded train / prefill / decode steps: the torch twin of the JAX
package's ``distributed/steps.py``, over a ``DeviceMesh``.

``make_*_step`` returns ``(step, placements, out_placements, meta)`` as
the reference returns ``(fn, in_shardings, out_shardings, shapes)``. The
reference's spec tables are the contract: every rank stores exactly the
block of each parameter, moment and cache leaf that the reference's device
stores (``partition.param_specs``/``opt_state_specs``/
``zero1_moment_specs``, ``cache_spec_tree``), and every step computes the
reference's result.

How the work is split:

* **The Megatron split** (``tensor_parallel.py``): the serve steps of a
  model whose ``splits`` is set (the dense, vlm, moe, ssm and hybrid
  families: ``TransformerLM``, ``Mamba2LM``, ``Zamba2LM``) and the ``tp``
  train step of one whose ``train_splits`` is set (the dense, vlm and moe
  families). The batch is split over ``data`` only
  (the reference's ``batch_specs``; not at all in ``long_500k``); each rank
  computes on the weight blocks it stores, heads, ``d_ff``, experts, SSM
  heads and channels and vocab over ``model``, and on the cache blocks it
  stores (an attention cache's sequence over ``model``, or ``data`` ×
  ``model`` in ``long_500k``; the SSM state and conv windows on their heads
  and channels over ``model``), moving activations and their gradients
  only. No weight is gathered over ``model`` and no
  cache row moves; the logits come back split on the vocab over ``model``.
  The MoE giants' leaves are also split over ``data`` on ``d_model`` (the
  reference's FSDP axis, ``partition.param_specs``): a layer's blocks are
  gathered over ``data`` at its entry, each keeping its ``model`` block,
  and the gather's backward reduce-scatters their gradient back
  (``tensor_parallel.weight``). The MoE dispatch routes the global batch
  over the ranks that split its rows (the step's ``Split`` names them), as
  the reference's does under ``jit``. The train step lets each rank's blocks
  require grad, takes the gradient of its data block's loss (a
  vocab-parallel cross-entropy) over ``data`` ranks and all-reduces over
  ``data`` each gradient that the gathers did not reduce, then runs AdamW
  on the blocks.
* **Training the ssm, hybrid and encdec families, the ``dp`` step, and
  serving the encdec family.** Each rank computes on
  its block of the global batch, taken over every mesh axis (``dp``'s batch
  spec; ``tp``'s leaves out ``model``, and the port splits over it too, so
  that no two ranks compute the same rows). The global batch must divide,
  or the step raises. Sharded weights are gathered a layer at a time at the
  layer's entry (``sharding.gather_tree``), FSDP-style; the backward of each
  gather reduce-scatters the layer's gradient to the leaf's blocks. Each
  rank's loss is its block's mean over ``n`` ranks, so the reduced gradient
  is the global batch's (the ``dp`` step tells ``TransformerLM`` the rows'
  split, ``tensor_parallel.row_split``, for its MoE dispatch). The ssm and
  hybrid families' training split and the encdec family's Megatron split are
  ROADMAP.md item 18.
* **Expert parallel.** With ``moe_ep`` the experts are split over ``model``
  on their dim 0 and tokens travel by all-to-all (``moe_ep.py``); in the
  split, each ``model`` rank sends its ``1/model`` of the rows.
* **The result is the reference's**; only the order of the sums differs.

The parameters are the model's own (the port's model owns its weights, as
``train/loop.make_step`` takes them): place them with :func:`shard_model`
and the optimizer state with :func:`init_opt_state`, then call the step on
``model.param_tree()``. On a mesh of one rank nothing is communicated and
the ``dp`` step is ``make_step``'s arithmetic, bit for bit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..launch.shapes import ShapeSpec
from ..models.config import ModelConfig, torch_dtype
from . import optimizer as optim
from . import tensor_parallel as tp
from .partition import (is_moment, opt_state_specs, param_specs, tree_map_with_path,
                        zero1_moment_specs)
from .sharding import (GradSink, Spec, _redistribute, axis_size, collect_grads,
                       decode_rules, is_dtensor, mesh_shape, note_placed, placements, train_rules,
                       use_rules)

Tree = Any

CONTEXT_PARALLEL_TODO = ("context-parallel decode over more than one rank runs for the families "
                         "that serve through the Megatron split (dense, vlm, moe, ssm, hybrid); "
                         "the encdec family's is ROADMAP.md item 18; on one rank it is today's "
                         "decode")

# ------------------------------------------------------------------ tables
def batch_specs(cfg: ModelConfig, shape: ShapeSpec, multi_pod: bool) -> Dict[str, Spec]:
    b = None if shape.context_parallel else (("pod", "data") if multi_pod else ("data",))
    specs: Dict[str, Spec] = {"tokens": (b, None)}
    if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
        specs["patch_embeds"] = (b, None, None)
    if cfg.family == "encdec" and shape.kind in ("train", "prefill"):
        specs["frames"] = (b, None, None)
    return specs


def _cache_axes(shape: ShapeSpec, multi_pod: bool) -> Tuple[Any, Any]:
    """(batch axes, sequence axes) of a cache."""
    if shape.context_parallel:
        return None, (("pod", "data", "model") if multi_pod else ("data", "model"))
    return (("pod", "data") if multi_pod else ("data",)), "model"


def _cache_leaf_spec(name: str, shp: Tuple[int, ...], shape: ShapeSpec, mesh: Any,
                     multi_pod: bool) -> Spec:
    """One cache leaf's spec, by its name and divisibility."""
    batch_ax, seq_ax = _cache_axes(shape, multi_pod)
    if name == "pos":
        return ()

    def div(dim_idx, ax):
        return ax is not None and shp[dim_idx] % axis_size(mesh, ax) == 0
    if name in ("k", "v", "ck", "cv"):  # (L, B, KV, S, hd)
        kv_ax = "model" if (seq_ax != "model" and div(2, "model")) else None
        s_ax = seq_ax if div(3, seq_ax) else None
        if kv_ax == "model" and s_ax and "model" in (s_ax if isinstance(s_ax, tuple) else (s_ax,)):
            kv_ax = None
        return (None, batch_ax if div(1, batch_ax) else None, kv_ax, s_ax, None)
    if name in ("latent", "k_rope", "kv"):  # (L, B, S, r)
        return (None, batch_ax if div(1, batch_ax) else None,
                seq_ax if div(2, seq_ax) else None, None)
    if name == "ssm":  # (L, B, H, P, N)
        return (None, batch_ax if div(1, batch_ax) else None,
                "model" if div(2, "model") else None, None, None)
    if name.startswith("conv"):  # (L, B, W-1, C)
        return (None, batch_ax if div(1, batch_ax) else None, None,
                "model" if div(3, "model") else None)
    return (None,) * len(shp)


def cache_spec_tree(cache_shape: Tree, shape: ShapeSpec, mesh: Any, multi_pod: bool) -> Tree:
    """Spec tree for a KV/state cache, by leaf name + divisibility. The
    port's MLA cache group also holds ``kv``, the stack whose column views
    are ``latent`` and ``k_rope``: it takes their spec."""
    return tree_map_with_path(
        lambda path, leaf: _cache_leaf_spec(path.rsplit("/", 1)[-1], tuple(leaf.shape), shape,
                                            mesh_shape(mesh), multi_pod), cache_shape)


def placement_tree(specs: Tree, like: Tree, mesh: Any) -> Tree:
    """DTensor placements for each spec of ``specs``, at the rank of the
    matching leaf of ``like``."""
    return tree_map_with_path(lambda _, sp, leaf: placements(sp, mesh, leaf.dim()),
                              specs, like, is_leaf=lambda x: isinstance(x, tuple))


# ---------------------------------------------------------------- helpers
def _leaves_with_paths(tree: Tree, path: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in the JAX pytree order (keys sorted), as ``optim.leaves``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_with_paths(tree[k], f"{path}/{k}"
                                                                  if path else str(k))]
    return [(path, tree)]


def _get(tree: Tree, path: str) -> Any:
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _shards(mesh, pl: Sequence) -> bool:
    """True when ``pl`` splits over a mesh dim of more than one rank."""
    return any(not isinstance(p, Replicate) and mesh.size(k) > 1 for k, p in enumerate(pl))


def _block(t: torch.Tensor, mesh, pl: Sequence) -> torch.Tensor:
    """This rank's block of a whole tensor under placements ``pl`` (a view):
    each ``Shard(d)`` in mesh order cuts dim d, major to minor."""
    coord = mesh.get_coordinate()
    for k, p in enumerate(pl):
        if isinstance(p, Shard) and mesh.size(k) > 1:
            n = mesh.size(k)
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not split over "
                                 f"{mesh.mesh_dim_names[k]} ({n})")
            t = t.chunk(n, p.dim)[coord[k]]
    return t


def _dtensor(local: torch.Tensor, mesh, pl: Sequence, shape: Sequence[int]):
    shape = tuple(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, list(pl), run_check=False, shape=shape,
                              stride=stride)


def _compute_axes(mesh, shape: ShapeSpec) -> Tuple[str, ...]:
    """Mesh axes the batch is split over for compute: all of them, but none
    for a context-parallel shape (one sequence)."""
    return () if shape.context_parallel else tuple(mesh.mesh_dim_names)


def _compute_placements(mesh, axes: Sequence[str], dim: int) -> List[Any]:
    return [Shard(dim) if name in axes else Replicate() for name in mesh.mesh_dim_names]


def _n_ranks(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh_shape(mesh)[a] for a in axes)


def _split_batch(batch: Dict[str, Any], mesh, axes: Sequence[str]) -> Dict[str, Any]:
    """This rank's block of each batch field, split on dim 0 over ``axes``:
    a ``DTensor`` redistributed there, a whole array (on every rank) cut."""
    n = _n_ranks(mesh, axes)
    out = {}
    for key, v in batch.items():
        if is_dtensor(v):
            pl = _compute_placements(mesh, axes, 0)
            out[key] = _redistribute(v.to_local(), mesh, list(v.placements), pl, tuple(v.shape))
            continue
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(v)
        if v.shape[0] % n:
            raise ValueError(f"the global batch's {key!r} {tuple(v.shape)} does not split over "
                             f"{n} ranks on mesh axes {tuple(axes)} of "
                             f"{mesh_shape(mesh)}")
        out[key] = _block(v, mesh, _compute_placements(mesh, axes, 0))
    return out


def _mean_over(mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each 0-d tensor's mean over every rank of ``mesh`` (one collective)."""
    if mesh.size() == 1 or not tensors:
        return tensors
    flat = torch.stack([t.to(torch.float32) for t in tensors])
    total = _redistribute(flat, mesh, [Partial()] * mesh.ndim, [Replicate()] * mesh.ndim,
                          tuple(flat.shape))
    return list((total / mesh.size()).to(tensors[0].dtype).unbind(0))


def _sum_over_shards(mesh, sums: List[Tuple[torch.Tensor, Sequence]]) -> List[torch.Tensor]:
    """Each leaf's sum of squares over the ranks its leaf is split over, and
    only those (a leaf replicated over an axis is counted once)."""
    out: List[Optional[torch.Tensor]] = [None] * len(sums)
    groups: Dict[Tuple[bool, ...], List[int]] = {}
    for i, (s, pl) in enumerate(sums):
        key = tuple(not isinstance(p, Replicate) and mesh.size(k) > 1 for k, p in enumerate(pl))
        groups.setdefault(key, []).append(i)
    for key, idx in groups.items():
        if not any(key):
            for i in idx:
                out[i] = sums[i][0]
            continue
        flat = torch.stack([sums[i][0] for i in idx])
        src = [Partial() if k else Replicate() for k in key]
        red = _redistribute(flat, mesh, src, [Replicate()] * mesh.ndim, tuple(flat.shape))
        for j, i in enumerate(idx):
            out[i] = red[j]
    return out


# ----------------------------------------------------------- placing state
def shard_model(model, mesh, param_pl: Tree) -> None:
    """Store each parameter of ``model`` as this rank's block of it, a
    ``DTensor`` with its placements; a leaf replicated everywhere stays a
    plain tensor (every rank holds it whole). Every rank must hold the same
    whole weights before (the same seed, or the same checkpoint)."""
    from torch import nn

    flat = dict(_leaves_with_paths(param_pl))
    for name, param in list(model.named_parameters()):
        pl = flat[name.replace(".", "/")]
        if all(isinstance(p, Replicate) for p in pl):
            continue
        note_placed()
        local = _block(param.data, mesh, pl).contiguous()
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = nn.Parameter(_dtensor(local, mesh, pl, param.shape),
                                             requires_grad=False)
    if hasattr(model, "params_changed"):
        model.params_changed()


def init_opt_state(opt_meta: Tree, mesh, opt_pl: Tree, device: Any) -> Dict[str, Any]:
    """Zero moments as ``DTensor``s of this rank's blocks (a quantized
    moment's ``scale`` at 1e-12, what quantizing zeros gives), and step 0."""

    def block(leaf, pl, fill: float):
        shape = tuple(leaf.shape)
        blk = _block(torch.empty(shape, device="meta"), mesh, pl).shape
        return _dtensor(torch.full(blk, fill, dtype=leaf.dtype, device=device), mesh, pl, shape)

    def local(_, leaf, pl):
        if is_moment(leaf):
            return {"q": block(leaf["q"], pl["q"], 0), "scale": block(leaf["scale"], pl["scale"],
                                                                     1e-12)}
        return block(leaf, pl, 0)

    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map_with_path(local, opt_meta["m"], opt_pl["m"], is_leaf=is_moment),
        "v": tree_map_with_path(local, opt_meta["v"], opt_pl["v"], is_leaf=is_moment),
    }


def _meta_model(model):
    from ..models import build_model

    return build_model(model.cfg, device="meta")


# ------------------------------------------------------------ the update
class _Moment:
    """A quantized moment on this rank's blocks, where its ``q`` is split on
    the last dim (a block of 128 may be cut between ranks, or the zero
    padding past the parameter's width may sit on another rank) or its
    ``scale`` is split otherwise than ``q``'s rows. Its rows are gathered
    whole along the last dim over the ranks that split it, so that
    ``quantize_blockwise`` and ``dequantize_blockwise`` run on whole blocks,
    as the reference quantizes the global array."""

    def __init__(self, mom: Dict[str, Any], mesh, n: int):
        q, scale = mom["q"], mom["scale"]
        self.mesh, self.q_dt, self.scale_dt, self.n = mesh, q, scale, n
        last = q.dim() - 1
        self.q_pl = list(q.placements)
        cut = [isinstance(p, Shard) and p.dim == last and mesh.size(k) > 1
               for k, p in enumerate(self.q_pl)]
        self.cut = any(cut)
        self.cols_pl = [p if c else Replicate() for p, c in zip(self.q_pl, cut)]
        self.rows_pl = [Replicate() if c else p for p, c in zip(self.q_pl, cut)]
        self.scale_pl = [Shard(p.dim) if isinstance(p, Shard) and p.dim < last else Replicate()
                         for p in self.q_pl]
        self.scale = _redistribute(scale.to_local(), mesh, list(scale.placements),
                                   self.scale_pl, tuple(scale.shape))
        self.moves_scale = self.scale.data_ptr() != scale.to_local().data_ptr()

    def dequantize(self) -> torch.Tensor:
        """This rank's block of the moment (the parameter's block), f32."""
        q = _redistribute(self.q_dt.to_local(), self.mesh, self.q_pl, self.rows_pl,
                          tuple(self.q_dt.shape))
        full = optim.dequantize_blockwise({"q": q, "scale": self.scale}, self.n)
        return _block(full, self.mesh, self.cols_pl)

    def store(self, x: torch.Tensor) -> None:
        """Quantize this rank's block ``x`` of the moment, whole rows at once."""
        shape = tuple(self.q_dt.shape[:-1]) + (self.n,)
        full = _redistribute(x.contiguous(), self.mesh, self.q_pl, self.rows_pl, shape)
        quant = optim.quantize_blockwise(full)
        self.q_dt.to_local().copy_(_block(quant["q"], self.mesh, self.cols_pl))
        back = _redistribute(quant["scale"], self.mesh, self.scale_pl,
                             list(self.scale_dt.placements), tuple(self.scale_dt.shape))
        self.scale_dt.to_local().copy_(back)


def _update_leaf(p, g, m, v, clip, lr, b1c, b2c, cfg: optim.AdamWConfig, mesh,
                 n_global: int) -> None:
    """One leaf's AdamW update on this rank's blocks ``p`` (of a leaf whose
    last dim is ``n_global`` wide): ``optim._update``'s arithmetic, layer at
    a time on stacked leaves; a quantized moment split along its blocks
    (:class:`_Moment`) takes the same arithmetic over whole rows."""
    def plain(mom):
        if not is_moment(mom):
            return mom.to_local() if is_dtensor(mom) else mom
        if not is_dtensor(mom["q"]):
            return mom
        mv = _Moment(mom, mesh, n_global)
        if mv.cut or mv.moves_scale:
            return mv
        return {"q": mom["q"].to_local(), "scale": mv.scale}

    m_l, v_l = plain(m), plain(v)
    if isinstance(m_l, _Moment) or isinstance(v_l, _Moment):
        g = g.to(torch.float32) * clip
        n = p.shape[-1] if p.dim() else 1

        def load(mom):
            if isinstance(mom, _Moment):
                return mom.dequantize()
            return optim.dequantize_blockwise(mom, n) if isinstance(mom, dict) else mom
        m_f = cfg.b1 * load(m_l) + (1 - cfg.b1) * g
        v_f = cfg.b2 * load(v_l) + (1 - cfg.b2) * g * g
        u = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
        if cfg.weight_decay and p.dim() >= 2:
            u = u + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
        for mom, val in ((m_l, m_f), (v_l, v_f)):
            if isinstance(mom, _Moment):
                mom.store(val)
            else:
                optim._store_moment(mom, val)
        return
    if optim._stacked(p):
        for i in range(p.shape[0]):
            optim._update(p[i], g[i], optim._layer(m_l, i), optim._layer(v_l, i),
                          clip, lr, b1c, b2c, cfg)
    else:
        optim._update(p, g, m_l, v_l, clip, lr, b1c, b2c, cfg)


# -------------------------------------------------------------------- train
def make_train_step(
    model,
    mesh,
    shape: ShapeSpec,
    *,
    multi_pod: bool = False,
    adamw: Optional[optim.AdamWConfig] = None,
    microbatches: int = 1,
    strategy: str = "tp",
    grad_dtype: Optional[str] = None,
    moe_ep: bool = False,
):
    """Returns ``(step, (param_pl, opt_pl, batch_pl), out_pl, (params_meta,
    opt_meta))``; ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` updates the parameters and the state in place.

    ``microbatches``: the gradients accumulate in f32 and are divided by k;
    the loss and metrics are the microbatches' mean. ``grad_dtype``: the
    gradients are cast before the cross-rank reduction. ``strategy="dp"``:
    parameters replicated (plain tensors), the moments split by
    ``zero1_moment_specs``; the gradients are reduce-scattered to the
    moments' blocks, AdamW runs on the blocks and the parameters are
    all-gathered. ``strategy="tp"``: parameters and moments split by
    ``param_specs``/``opt_state_specs``, each rank holding its blocks; a
    model whose ``train_splits`` is set computes on them (the Megatron
    split: :func:`_block_grads`), the others gather a layer at a time."""
    cfg = model.cfg
    adamw = adamw or optim.AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
    rules = dict(train_rules(multi_pod, strategy))
    if moe_ep:
        rules["_moe_ep"] = True
    gdt = torch_dtype(grad_dtype) if grad_dtype else None
    k = microbatches

    params_meta = _meta_model(model).param_tree()
    opt_meta = optim.init_state(params_meta, adamw)
    pspecs = param_specs(params_meta, cfg, mesh, strategy=strategy)
    if strategy == "dp":
        ospecs = zero1_moment_specs(opt_meta, mesh)
    else:
        ospecs = opt_state_specs(opt_meta, pspecs)
    bspecs = batch_specs(cfg, shape, multi_pod)
    if strategy == "dp":
        bspecs = {key: (("data", "model"),) + (None,) * (len(v) - 1) for key, v in bspecs.items()}
    param_pl = placement_tree(pspecs, params_meta, mesh)
    opt_pl = {"step": [], "m": None, "v": None}
    for part in ("m", "v"):
        opt_pl[part] = placement_tree(ospecs[part], opt_meta[part], mesh)
    batch_pl = {key: placements(sp, mesh, len(sp)) for key, sp in bspecs.items()}
    # the layout each gradient is reduced to: its moment's (dp) or its leaf's (tp)
    grad_pl = {}
    for path, _ in _leaves_with_paths(params_meta):
        mom = _get(opt_pl["m"], path)
        grad_pl[path] = mom["q"] if isinstance(mom, dict) else mom
    if strategy == "tp" and model.train_splits:
        axes = _data_axes(mesh, shape, multi_pod)
        grads_for = _block_grads(model, mesh, axes)
        reduce = _reduce_over(mesh, axes)
    else:
        axes = _compute_axes(mesh, shape)
        grads_for = _gathered_grads(model, mesh, axes, gdt if k == 1 else None)
        reduce = _reduce_to_moments(mesh, grad_pl)

    def train_step(params, opt_state, batch):
        leaves = _leaves_with_paths(params)
        with use_rules(rules, mesh):
            local = _split_batch(batch, mesh, axes)
            rows = next(iter(local.values())).shape[0]
            if rows % k:
                raise ValueError(f"{rows} rows a rank do not split into {k} microbatches")
            acc: Optional[Dict[str, torch.Tensor]] = None
            mb_metrics: List[Dict[str, torch.Tensor]] = []
            with grads_for(leaves) as take:
                for j in range(k):
                    mb = {key: v[j * rows // k:(j + 1) * rows // k] for key, v in local.items()}
                    metrics, grads = take(mb)
                    mb_metrics.append({key: v.detach() for key, v in metrics.items()})
                    if k == 1:
                        break
                    if acc is None:
                        acc = {path: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                               for path, g in grads.items()}
                    for path, g in grads.items():
                        acc[path] = acc[path] + g.to(torch.float32)
                    del grads
            if k > 1:
                grads = {path: g / k for path, g in acc.items()}
                metrics = {key: torch.stack([m[key] for m in mb_metrics]).mean(0)
                           for key in mb_metrics[0]}
            else:
                metrics = mb_metrics[0]
            if gdt is not None:
                grads = {path: g.to(gdt) for path, g in grads.items()}
            reduce(leaves, grads)
            names = list(metrics)  # the same on every model rank of a split step
            metrics = dict(zip(names, _mean_over(mesh, [metrics[key] for key in names])))
            new_opt, info = _apply_updates(params, leaves, grads, grad_pl, opt_state, adamw,
                                           mesh)
            return params, new_opt, {**metrics, **info}

    out_pl = (param_pl, opt_pl, None)  # metrics: replicated
    return train_step, (param_pl, opt_pl, batch_pl), out_pl, (params_meta, opt_meta)


def _block_grads(model, mesh, axes: Sequence[str]):
    """The Megatron split's gradients: each rank's stored blocks require
    grad for the step (and no longer after it, also where it raises); the
    model's ``train_loss`` under the mesh's ``Split``, the loss divided by
    the ``axes`` (``data``) ranks only, since the ``model`` ranks compute one
    batch block together. On one rank this is ``make_step``'s arithmetic."""
    sp = tp.make_split(mesh, row_axes=axes)
    n = _n_ranks(mesh, axes)

    @contextlib.contextmanager
    def grads_for(leaves):
        blocks = {path: tp.local(p) for path, p in leaves}

        def take(mb):
            loss, metrics = model.train_loss(mb, split=sp)
            (loss / n if n > 1 else loss).backward()
            grads = {}
            for path, b in blocks.items():
                grads[path] = b.grad if b.grad is not None else torch.zeros_like(b)
                b.grad = None
            return metrics, grads

        for b in blocks.values():
            b.requires_grad_(True)
        try:
            yield take
        finally:  # the stored blocks, as they were between steps
            for b in blocks.values():
                b.requires_grad_(False)

    return grads_for


def _gathered_grads(model, mesh, axes: Sequence[str], sink_dtype: Optional[torch.dtype]):
    """The gathered weights' gradients: a ``DTensor`` leaf's reduce-scattered
    to its blocks by its gathers' backwards (``GradSink``, cast to
    ``sink_dtype`` there), a plain leaf's whole on each rank; each rank's
    loss divided by the ``axes`` ranks. A model that takes a split (the
    ``dp`` step of ``TransformerLM``) is told the rows' split over ``axes``
    (``tensor_parallel.row_split``), so that its MoE dispatch is the global
    batch's."""
    n = _n_ranks(mesh, axes)
    kw = {"split": tp.row_split(mesh, axes)} if model.train_splits else {}

    @contextlib.contextmanager
    def grads_for(leaves):
        sharded = any(is_dtensor(p) for _, p in leaves)
        for _, p in leaves:
            p.requires_grad_(not is_dtensor(p))

        def take(mb):
            sink = GradSink(sink_dtype) if sharded else None
            with collect_grads(sink) if sink else contextlib.nullcontext():
                loss, metrics = model.train_loss(mb, **kw)
                (loss / n if n > 1 else loss).backward()
            grads = {}
            for path, p in leaves:
                if is_dtensor(p):
                    g = sink.grad(p)
                    grads[path] = g if g is not None else torch.zeros_like(p.to_local())
                else:
                    grads[path] = p.grad if p.grad is not None else torch.zeros_like(p)
                    p.grad = None
            return metrics, grads

        yield take

    return grads_for


def _reduce_over(mesh, axes: Sequence[str]):
    """Each gradient all-reduced in place over ``axes``: the ``data`` ranks'
    shares of the global batch's gradient of a block. A leaf split over
    such an axis (the FSDP axis) is left: its gathers' backwards
    reduce-scattered its gradient there."""
    import torch.distributed as dist

    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes if a in names and mesh.size(names.index(a)) > 1]

    def reduce(leaves, grads):
        for k in dims:
            group = mesh.get_group(names[k])
            for path, p in leaves:
                if not (is_dtensor(p) and isinstance(p.placements[k], Shard)):
                    dist.all_reduce(grads[path], group=group)

    return reduce


def _reduce_to_moments(mesh, grad_pl: Dict[str, Any]):
    """``dp``: each plain leaf's gradient reduce-scattered to its moment's
    blocks (a ``DTensor`` leaf's is already on its blocks)."""

    def reduce(leaves, grads):
        for path, p in leaves:
            if not is_dtensor(p):
                grads[path] = _redistribute(grads[path].contiguous(), mesh,
                                            [Partial()] * mesh.ndim, grad_pl[path],
                                            tuple(p.shape))

    return reduce


@torch.no_grad()
def _apply_updates(params, leaves, grads, grad_pl, state, cfg: optim.AdamWConfig, mesh):
    """``optim.apply_updates`` on each rank's blocks: the global norm from
    each leaf's sum of squares reduced over the ranks its gradient is split
    over; plain (replicated) parameters are updated on their moment's block
    and all-gathered."""
    step = state["step"] + 1
    lr = optim._lr_at(step, cfg)
    sums = [(torch.sum(torch.square(grads[path].to(torch.float32))),
             grad_pl[path] if not is_dtensor(p) else list(p.placements))
            for path, p in leaves]
    gnorm = torch.sqrt(sum(_sum_over_shards(mesh, sums)))
    clip = (torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
            if cfg.grad_clip else 1.0)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device), step.to(torch.float32))
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device), step.to(torch.float32))
    for path, p in leaves:
        m, v = _get(state["m"], path), _get(state["v"], path)
        if is_dtensor(p):
            _update_leaf(p.to_local(), grads[path], m, v, clip, lr, b1c, b2c, cfg, mesh,
                         p.shape[-1] if p.dim() else 1)
            continue
        pl = grad_pl[path]
        blk = _block(p.data, mesh, pl)
        _update_leaf(blk, grads[path], m, v, clip, lr, b1c, b2c, cfg, mesh,
                     p.shape[-1] if p.dim() else 1)
        if _shards(mesh, pl):
            p.data.copy_(_redistribute(blk.contiguous(), mesh, pl,
                                       [Replicate()] * mesh.ndim, tuple(p.shape)))
        grads[path] = None
    state["step"] = step
    return state, {"lr": lr, "grad_norm": gnorm}


# -------------------------------------------------------------------- serve
def _serve_args(model, batch: Dict[str, Any]) -> Tuple[Any, ...]:
    """``prefill``'s positional arguments for the model's family."""
    if model.cfg.family == "encdec":
        return batch["frames"], batch["tokens"]
    if model.cfg.family == "vlm" and "patch_embeds" in batch:
        return batch["tokens"], batch["patch_embeds"]
    return (batch["tokens"],)


def _map_cache(fn, cache: Dict[str, Any], *others: Dict[str, Any]) -> Dict[str, Any]:
    """``fn(name, leaf, *other_leaves)`` over a cache's leaves; an MLA
    group's ``latent``/``k_rope`` are rebuilt as column views of its ``kv``."""
    out: Dict[str, Any] = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            out[key] = _map_cache(fn, val, *(o[key] for o in others))
        elif not ("kv" in cache and key in ("latent", "k_rope")):
            out[key] = fn(key, val, *(o[key] for o in others))
    if "kv" in cache:
        r = cache["latent"].shape[-1]
        out["latent"], out["k_rope"] = _columns(out["kv"], 0, r), _columns(out["kv"], r, None)
    return out


def _columns(t, lo: int, hi: Optional[int]):
    """Columns ``lo:hi`` of the last dim, a view (of the local block of a
    ``DTensor`` whose last dim is whole)."""
    if not is_dtensor(t):
        return t[..., lo:hi]
    gshape = tuple(t.shape)
    width = (gshape[-1] if hi is None else hi) - lo
    return _dtensor(t.to_local()[..., lo:hi], t.device_mesh, t.placements,
                    gshape[:-1] + (width,))


def _global_rows(t: torch.Tensor, n: int) -> Tuple[int, ...]:
    """A cache leaf's global shape from this rank's rows (its dim 1)."""
    return (t.shape[0], t.shape[1] * n) + tuple(t.shape[2:])


def _store_cache(cache: Tree, mesh, shape: ShapeSpec, multi_pod: bool, axes) -> Tree:
    """A cache computed on this rank's rows, as ``DTensor``s stored by
    ``cache_spec_tree`` (``pos`` stays a plain replicated scalar)."""
    n = _n_ranks(mesh, axes)
    src = _compute_placements(mesh, axes, 1)

    def store(name, t):
        if name == "pos":
            return t
        gshape = _global_rows(t, n)
        pl = placements(_cache_leaf_spec(name, gshape, shape, mesh_shape(mesh), multi_pod),
                        mesh, t.dim())
        return _dtensor(_redistribute(t.contiguous(), mesh, src, pl, gshape), mesh, pl, gshape)

    return _map_cache(store, cache)


def _local_cache(cache: Tree, mesh, axes) -> Tree:
    """A stored cache as this rank's rows, plain tensors (the storage itself
    where nothing moves, so the model's in-place writes land there)."""
    dst = _compute_placements(mesh, axes, 1)

    def local(name, t):
        if not is_dtensor(t):
            return t
        return _redistribute(t.to_local(), mesh, list(t.placements), dst, tuple(t.shape))

    return _map_cache(local, cache)


def _check_context_parallel(mesh, shape: ShapeSpec, model) -> None:
    if shape.context_parallel and mesh.size() > 1 and not model.splits:
        raise NotImplementedError(CONTEXT_PARALLEL_TODO)


def _data_axes(mesh, shape: ShapeSpec, multi_pod: bool) -> Tuple[str, ...]:
    """The mesh axes a split serve step's batch is split over: the
    reference's ``batch_specs`` (none in a context-parallel shape)."""
    if shape.context_parallel:
        return ()
    names = mesh.mesh_dim_names
    return tuple(a for a in (("pod", "data") if multi_pod else ("data",)) if a in names)


#: the sequence dim of each attention cache leaf: GQA's (L, B, KV, S, hd), MLA's (L, B, S, r)
SEQ_DIM = {"k": 3, "v": 3, "kv": 2, "latent": 2, "k_rope": 2}


def _seq_split(mesh, pl: Sequence, shape: Sequence[int], dim: int
               ) -> Tuple[Tuple[str, ...], int, int]:
    """(mesh axes that split an attention cache leaf's sequence, its dim
    ``dim``, this rank's first row, its rows) from the leaf's placements and
    global shape; a leaf split otherwise than on its sequence and batch
    raises."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    axes, block, n = [], 0, 1
    for k, p in enumerate(pl):
        if not isinstance(p, Shard) or mesh.size(k) == 1:
            continue
        if p.dim == dim:
            axes.append(names[k])
            block, n = block * mesh.size(k) + coord[k], n * mesh.size(k)
        elif p.dim != 1:
            raise NotImplementedError(
                f"the split serve steps take a cache split on its batch and sequence only; "
                f"this one is {list(pl)} (its capacity does not divide the ranks that split it)")
    rows = shape[dim] // n
    return tuple(axes), block * rows, rows


def _rows_of(mesh, leaves: Sequence[Tuple[str, Any, Tuple[int, ...]]]
             ) -> Tuple[Tuple[str, ...], int, int]:
    """(the axes that split a cache's sequence, this rank's first row, its
    rows) from its attention leaves' ``(path, placements or None for a whole
    leaf, global shape)`` (``SEQ_DIM``), which must agree; ``((), 0, 0)`` for
    a cache without one (Mamba2's: its state does not grow with the
    sequence)."""
    got = set()
    for path, pl, shp in leaves:
        dim = SEQ_DIM.get(path.rsplit("/", 1)[-1])
        if dim is not None:
            got.add(((), 0, shp[dim]) if pl is None else _seq_split(mesh, pl, shp, dim))
    if not got:
        return (), 0, 0
    if len(got) != 1:
        raise ValueError(f"the cache's attention leaves split their sequence unalike: {got}")
    return got.pop()


def _split_prefill(model, meta, mesh, shape: ShapeSpec, multi_pod: bool,
                   capacity: Optional[int], batch: Dict[str, Any]):
    """A split family's prefill step (the module docstring's Megatron
    split): each cache leaf's global shape and placements are those of the
    meta model's own cache (``meta.empty_cache``) by ``cache_spec_tree``."""
    cfg = model.cfg
    axes = _data_axes(mesh, shape, multi_pod)
    local = _split_batch(batch, mesh, axes)
    args = _serve_args(model, local)
    n = _n_ranks(mesh, axes)
    B = args[0].shape[0] * n
    S = args[0].shape[1] + (args[1].shape[1] if len(args) > 1 else 0)
    cap = capacity or S
    gmeta = meta.empty_cache(B, cap)
    pl = placement_tree(cache_spec_tree(gmeta, shape, mesh, multi_pod), gmeta, mesh)
    seq_axes, start, rows = _rows_of(mesh, [
        (path, _get(pl, path), tuple(t.shape)) for path, t in _leaves_with_paths(gmeta)])
    logits, cache = model.prefill(*args, capacity=cap, split=tp.make_split(
        mesh, seq_axes=seq_axes, kv_start=start, rows=rows, row_axes=axes))

    def store(name, t, p, like):
        if name == "pos":
            return t
        return _dtensor(t, mesh, p, tuple(like.shape))
    return _split_logits(logits, mesh, axes, cfg), _map_cache(store, cache, pl, gmeta)


def _split_logits(logits: torch.Tensor, mesh, axes: Sequence[str], cfg: ModelConfig):
    """This rank's logits block as a ``DTensor``: the batch split over
    ``axes``, the vocab over ``model`` where the rank holds part of it."""
    pl = _compute_placements(mesh, axes, 0)
    if logits.shape[-1] != cfg.vocab:
        pl[list(mesh.mesh_dim_names).index(tp.MODEL)] = Shard(logits.dim() - 1)
    return _dtensor(logits, mesh, pl, (logits.shape[0] * _n_ranks(mesh, axes),) +
                    tuple(logits.shape[1:-1]) + (cfg.vocab,))


def _split_decode(model, mesh, shape: ShapeSpec, multi_pod: bool, cache, tokens):
    """A split family's decode step: the cache stays in its placements, each
    rank writing and attending its own rows in place."""
    axes = _data_axes(mesh, shape, multi_pod)
    tok = _split_batch({"tokens": tokens}, mesh, axes)["tokens"]
    seq_axes, start, rows = _rows_of(mesh, [
        (path, list(t.placements) if is_dtensor(t) else None, tuple(t.shape))
        for path, t in _leaves_with_paths(cache)])
    local = _map_cache(lambda _, t: t.to_local() if is_dtensor(t) else t, cache)
    logits, local = model.decode_step(local, tok, split=tp.make_split(
        mesh, seq_axes=seq_axes, kv_start=start, rows=rows, row_axes=axes))

    def back(_, t, was):
        if not is_dtensor(was):
            return t
        return _dtensor(t, mesh, list(was.placements), tuple(was.shape))
    return _split_logits(logits, mesh, axes, model.cfg), _map_cache(back, local, cache)


def make_prefill_step(model, mesh, shape: ShapeSpec, *, multi_pod: bool = False,
                      capacity: Optional[int] = None):
    """Returns ``(step, (param_pl, batch_pl), out_pl, params_meta)``;
    ``step(params, batch) -> (logits, cache)`` runs the model's ``prefill``
    under ``decode_rules``: the logits a ``DTensor`` split on the batch (and,
    for the families that split, on the vocab over ``model``), the cache
    stored by ``cache_spec_tree``. With ``capacity`` (an attention cache's
    positions: ``TransformerLM``, ``Zamba2LM``) the cache has room for the
    decode steps that follow."""
    cfg = model.cfg
    rules = decode_rules(multi_pod, shard_kv_seq=shape.context_parallel)
    meta = _meta_model(model)
    params_meta = meta.param_tree()
    param_pl = placement_tree(param_specs(params_meta, cfg, mesh), params_meta, mesh)
    batch_pl = {key: placements(sp, mesh, len(sp))
                for key, sp in batch_specs(cfg, shape, multi_pod).items()}
    axes = _compute_axes(mesh, shape)

    def prefill_step(params, batch):
        del params  # the model's own, placed by shard_model
        _check_context_parallel(mesh, shape, model)
        if model.splits:
            with use_rules(rules, mesh):
                return _split_prefill(model, meta, mesh, shape, multi_pod, capacity, batch)
        with use_rules(rules, mesh):
            local = _split_batch(batch, mesh, axes)
            kw = {} if capacity is None else {"capacity": capacity}
            logits, cache = model.prefill(*_serve_args(model, local), **kw)
        n = _n_ranks(mesh, axes)
        logits = _dtensor(logits, mesh, _compute_placements(mesh, axes, 0),
                          (logits.shape[0] * n,) + tuple(logits.shape[1:]))
        return logits, _store_cache(cache, mesh, shape, multi_pod, axes)

    return prefill_step, (param_pl, batch_pl), None, params_meta


def make_decode_step(model, mesh, shape: ShapeSpec, *, multi_pod: bool = False):
    """Returns ``(step, (param_pl, cache_pl, tok_pl), out_pl, (params_meta,
    cache_meta))``; ``step(params, cache, tokens) -> (logits, cache)`` runs
    ``decode_step`` (the split of the dense, vlm, moe, ssm and hybrid families;
    the encdec family's on this rank's rows of the batch, its weights
    gathered) and hands back the cache in the placements it took."""
    cfg = model.cfg
    rules = decode_rules(multi_pod, shard_kv_seq=shape.context_parallel)
    meta = _meta_model(model)
    params_meta = meta.param_tree()
    param_pl = placement_tree(param_specs(params_meta, cfg, mesh), params_meta, mesh)
    cache_meta = meta.empty_cache(shape.batch, shape.seq)
    cache_pl = placement_tree(cache_spec_tree(cache_meta, shape, mesh, multi_pod), cache_meta,
                              mesh)
    b = None if shape.context_parallel else (("pod", "data") if multi_pod else ("data",))
    tok_pl = placements((b, None), mesh, 2)
    axes = _compute_axes(mesh, shape)

    def decode_step(params, cache, tokens):
        del params
        _check_context_parallel(mesh, shape, model)
        if model.splits:
            with use_rules(rules, mesh):
                return _split_decode(model, mesh, shape, multi_pod, cache, tokens)
        with use_rules(rules, mesh):
            local = _local_cache(cache, mesh, axes)
            tok = _split_batch({"tokens": tokens}, mesh, axes)["tokens"]
            logits, local = model.decode_step(local, tok)
        n = _n_ranks(mesh, axes)
        src = _compute_placements(mesh, axes, 1)

        def back(_, t, was):
            if not is_dtensor(was):
                return t
            pl, gshape = list(was.placements), tuple(was.shape)
            return _dtensor(_redistribute(t.contiguous(), mesh, src, pl, gshape), mesh, pl,
                            gshape)
        new = _map_cache(back, local, cache)
        logits = _dtensor(logits, mesh, _compute_placements(mesh, axes, 0),
                          (logits.shape[0] * n,) + tuple(logits.shape[1:]))
        return logits, new

    out_pl = (None, cache_pl)
    return decode_step, (param_pl, cache_pl, tok_pl), out_pl, (params_meta, cache_meta)

