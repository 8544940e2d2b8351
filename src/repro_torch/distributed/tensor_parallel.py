"""The Megatron split over the mesh's ``model`` axis, of the serve steps and
of the ``tp`` train step (with the MoE giants' FSDP gather over ``data``),
and the split-S combine of context-parallel decode: functions on tensors
over the mesh's process groups.

The reference has no such module: GSPMD writes this for it from the spec
tables (``partition.param_specs``, ``steps.cache_spec_tree``), which fix
what each rank holds. Inside a serve step (``steps.make_prefill_step``/
``make_decode_step``, dense, vlm and moe families) a rank computes on the
blocks it stores and moves only activations (the ssm and hybrid families'
Mamba2 layers too, below):

* **weights** are the local blocks of their ``DTensor``s, split over
  ``model`` on heads, ``head_dim``, ``d_ff``, experts or vocab, or whole
  where the dim does not divide (a block's shape says which:
  :func:`offset`);
* **column-parallel** products (``wq``/``wk``/``wv`` on heads, ``w_up``/
  ``w_gate``, ``lm_head``) need nothing; a product split on ``head_dim``
  (``wk``/``wv`` where the KV heads do not divide ``model``) and ``mm_proj``
  all-gather their output, the activation, never the weight;
* **row-parallel** products (``wo``, ``w_down``) all-reduce their output
  over ``model`` (:func:`all_reduce`), as does the vocab-parallel embedding
  (:func:`embed`);
* **decode attention**: each rank attends the cache rows it holds (the
  cache's sequence is split over ``model``, or ``data`` × ``model`` in
  ``long_500k``) through the decode kernel's slice call, and the ranks'
  partials are merged by :func:`combine`: an all-reduce of the max of the
  log-sum-exps, then one of the weighted sums;
* **Mamba2 layers** (``models/mamba.py``, the ssm and hybrid families):
  ``w_z``/``w_x``/``w_dt`` and the convolutions are column-parallel on the
  rank's ``d_inner`` channels and its SSM heads (whole ``(H,)`` leaves
  sliced to them), the scan runs on those heads; ``w_B``/``w_C`` split on
  ``G·N`` give the rank's columns of the convolved B and C, all-gathered
  (:func:`all_gather_for_split`: every head reads all of N); the gated
  RMSNorm over the split ``d_inner`` sums the blocks' shares of its mean
  square over ``model``
  (:func:`sum_over_model`); ``out_proj`` is row-parallel. Zamba2's
  ``shared/out_proj`` is stored split on its input: each rank takes its
  block of the shared attention's all-reduced output;
* **the batch's row blocks**: where a step splits the global batch's rows
  over mesh axes (``data``/``pod`` in the split steps, every axis in the
  ``dp`` step), :class:`Split` names their groups and this rank's block, so
  that the MoE dispatch (``models/moe.py``) routes the global batch, as the
  reference's ``moe_ffn`` does under ``jit``: its sums over the blocks go
  through :func:`sum_over_rows`.

A serve step hands its :class:`Split` to the model's ``prefill``/
``decode_step`` (``split=``), the ``tp`` train step to its ``train_loss``.
Without one, a GQA model without MoE layers computes under :data:`ONE`, the
split of one rank: its blocks are the whole weights and cache, every
collective is the identity and the combine of one partial returns it, so a
step on a one-rank mesh and the model's own call run the same code.

**Training** runs the same products under autograd, Megatron's way. The
residual stream is whole on every ``model`` rank, and so is its gradient.
Each collective is an autograd op, the identity (and no op at all) on one
rank, and under ``torch.no_grad`` or on tensors that need no gradient the
serve steps' plain collective:

* :func:`copy_to_model` (Megatron's ``f``) at the entry of a column-parallel
  product (``wq``/``wk``/``wv``, ``w_up``/``w_gate``, ``lm_head``, the tied
  ``embed``): the identity forward, an all-reduce of the gradient backward,
  whose every rank holds only its heads' or columns' share. A whole leaf
  used inside such a region (QK-norm's scales, a bias or a ``wk`` that the
  mesh does not split) takes it too: its gradient is a share as well;
* :func:`reduce_from_model` (``g``) for the row-parallel outputs (``wo``,
  ``w_down``) and the vocab-parallel embedding: an all-reduce forward (out
  of place), the identity backward;
* two all-gathers that differ in their backward only:
  :func:`all_gather_for_replicated` where the gathered tensor feeds the
  residual stream (``mm_proj``'s output: its gradient is whole on every
  rank, so a rank keeps its slice) and :func:`all_gather_for_split` where it
  feeds ranks that each use a part (``wk``/``wv`` split on ``head_dim``: each
  rank's gradient is its query heads' share, so the backward sums over
  ``model`` before taking the slice);
* :func:`reduce_scatter` where a product is split on its contraction and
  its consumer on another dim (the experts' ``w_gate``/``w_up``, stored on
  ``d_model`` over ``model``, feed ``w_down``, stored on the experts): the
  partial sums summed to this rank's block forward, the gradient
  all-gathered backward;
* :func:`cross_entropy`, the vocab-parallel loss over each rank's logit
  columns, equal to ``models/common.py:cross_entropy_loss`` on the whole
  logits, gradient included (the reference's extra one-hot at the argmax,
  ROADMAP.md §3 fault 3, lands once, on the rank that holds the argmax).

**The FSDP axis.** The MoE giants' leaves are split over ``data`` too, on
``d_model`` (``partition.py``'s ``F``). The train step hands each layer
what :func:`stored` gives, and :func:`weight` gathers a leaf over every
axis but ``model`` at its layer's entry, keeping its ``model`` block,
through ``sharding.regather`` (``sharding._Gather`` without a sink): its
backward reduce-scatters the gradient back to the block, so the step
all-reduces over ``data`` only the leaves the mesh does not split there.
On one rank it is the block itself.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from .sharding import is_dtensor, regather

MODEL = "model"


class Split(NamedTuple):
    """What a rank needs to compute its part of a serve step.

    ``model``/``rank``: the size of the mesh's ``model`` axis and this
    rank's coordinate on it; ``kv_start``/``rows``: the global position of
    this rank's first cache row and how many it holds; ``model_groups``/
    ``seq_groups``: the process groups of ``model`` and of the mesh axes
    that split the cache's sequence (the combine's), those of more than one
    rank only, so that a step looks none up; ``mesh``: the step's mesh (None
    in :data:`ONE`, a model's own call); ``row_groups``/``row_block``/
    ``row_blocks``: the groups of the mesh axes that split the global
    batch's rows, this rank's block of them (major to minor over those
    axes) and their number (1: this rank holds every row)."""

    model: int
    rank: int
    kv_start: int = 0
    rows: int = 0
    model_groups: Tuple[Any, ...] = ()
    seq_groups: Tuple[Any, ...] = ()
    mesh: Any = None
    row_groups: Tuple[Any, ...] = ()
    row_block: int = 0
    row_blocks: int = 1


def axis_groups(mesh, axes: Sequence[str]) -> Tuple[Any, ...]:
    """The process groups of those of ``axes`` that ``mesh`` has with more
    than one rank."""
    names = list(mesh.mesh_dim_names)
    return tuple(mesh.get_group(a) for a in axes
                 if a in names and mesh.size(names.index(a)) > 1)


def _row_blocks(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of the rows split over
    ``axes``, major to minor in the order given."""
    names, coord = list(mesh.mesh_dim_names), mesh.get_coordinate()
    block, n = 0, 1
    for a in axes:
        if a in names:
            k = names.index(a)
            block, n = block * mesh.size(k) + coord[k], n * mesh.size(k)
    return block, n


def make_split(mesh, *, seq_axes: Sequence[str] = (), kv_start: int = 0,
               rows: int = 0, row_axes: Sequence[str] = ()) -> Split:
    """A step's split over ``mesh``: weights over ``model``, the cache's
    sequence over ``seq_axes``, the global batch's rows over ``row_axes``."""
    names = list(mesh.mesh_dim_names)
    if MODEL in names:
        k = names.index(MODEL)
        model, rank = mesh.size(k), mesh.get_coordinate()[k]
    else:
        model, rank = 1, 0
    block, n = _row_blocks(mesh, row_axes)
    return Split(model, rank, kv_start, rows, axis_groups(mesh, (MODEL,)),
                 axis_groups(mesh, seq_axes), mesh, axis_groups(mesh, row_axes), block, n)


def row_split(mesh, row_axes: Sequence[str]) -> Split:
    """One rank's split of the weights (every one whole) with the global
    batch's rows over ``row_axes``: the ``dp`` step's, whose batch is split
    over every mesh axis while each rank holds the whole weights."""
    block, n = _row_blocks(mesh, row_axes)
    return ONE._replace(row_groups=axis_groups(mesh, row_axes), row_block=block, row_blocks=n)


#: one rank: whole weights and cache, no collective
ONE = Split(1, 0)


def local(x: Any) -> torch.Tensor:
    """The block this rank stores: a ``DTensor``'s local tensor itself (the
    one the ``tp`` train step lets require grad, so that every use of it,
    each layer's view included, adds into its ``.grad``), a plain tensor
    itself. Under ``torch.no_grad()`` (serving) ``to_local()`` returns this
    same tensor; under grad it returns a new autograd alias at each call,
    whose gradients would not reach the block. ``_local_tensor`` is torch's
    private attribute of a ``DTensor`` (torch 2.x)."""
    return x._local_tensor if is_dtensor(x) else x


class Placed(NamedTuple):
    """This rank's block of a weight (or of one layer of a stacked one) on a
    mesh of several ranks, with what a gather of it needs: its placements
    and its global shape (:func:`stored`, :func:`weight`)."""

    block: torch.Tensor
    mesh: Any
    placements: Tuple[Any, ...]
    shape: Tuple[int, ...]


def stored(leaf: Any, layers: bool = False) -> Any:
    """A parameter as the split computes on it: a plain tensor itself, a
    ``DTensor`` its local block (:func:`local`), as a :class:`Placed` on a
    mesh of several ranks. With ``layers``, the layers of a stacked leaf, a
    list from one ``unbind`` (under autograd each leaf's gradient is then
    stacked once from its layers'), each with its layer's placements."""
    if not is_dtensor(leaf):
        return list(leaf.unbind(0)) if layers else leaf
    blk, mesh = local(leaf), leaf.device_mesh
    if mesh.size() == 1:
        return list(blk.unbind(0)) if layers else blk
    pl, shape = tuple(leaf.placements), tuple(leaf.shape)
    if not layers:
        return Placed(blk, mesh, pl, shape)
    if any(isinstance(p, Shard) and p.dim == 0 for p in pl):
        raise ValueError("a layer stack's dim 0 is never sharded")
    pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pl)
    return [Placed(b, mesh, pl, shape[1:]) for b in blk.unbind(0)]


def weight(x: Any, experts: bool = False) -> Any:
    """A weight as this rank computes on it, from what :func:`stored` gives
    (a ``DTensor`` is taken through it first): a :class:`Placed` block
    gathered over every mesh axis but ``model`` where it is split there (the
    MoE giants' FSDP axis, ``data`` on ``d_model``: ``partition.py``'s
    ``F``), its ``model`` block kept; with ``experts``, split on its dim 0
    (the experts) over ``model`` instead, as the expert-parallel FFN takes
    them (a block split otherwise over ``model`` moves there by an
    all-to-all). The gather is ``sharding.regather``: its backward
    reduce-scatters the gradient back to the block. A tensor is itself."""
    if is_dtensor(x):
        x = stored(x)
    if not isinstance(x, Placed):
        return x
    target = [(Shard(0) if experts else p) if name == MODEL else Replicate()
              for name, p in zip(x.mesh.mesh_dim_names, x.placements)]
    return regather(x.block, x.mesh, list(x.placements), target, x.shape)


def gathers(leaf: Any) -> bool:
    """True where :func:`weight` gathers ``leaf`` over a mesh axis of
    several ranks (the FSDP axis), False where it is the stored block."""
    x = stored(leaf) if is_dtensor(leaf) else leaf
    return isinstance(x, Placed) and any(
        name != MODEL and isinstance(p, Shard) and x.mesh.size(k) > 1
        for k, (name, p) in enumerate(zip(x.mesh.mesh_dim_names, x.placements)))


def weights(tree: Any, keep: Sequence[str] = ()) -> Any:
    """:func:`weight` over a layer's nested dict of what :func:`stored`
    gives, at the layer's entry; keys in ``keep`` stay as they are (the
    experts, which the expert-parallel FFN takes by ``weight(experts=True)``)."""
    if isinstance(tree, dict):
        return {k: (v if k in keep else weights(v, keep)) for k, v in tree.items()}
    return weight(tree)


def offset(n_local: int, n_global: int, sp: Split) -> int:
    """The global index of a block's first entry along a dim of ``n_global``
    that the block holds ``n_local`` of: 0 when whole, else this rank's
    share of a split over ``model``."""
    if n_local == n_global:
        return 0
    if n_local * sp.model != n_global:
        raise ValueError(f"a block of {n_local} of {n_global} is neither whole nor split over "
                         f"{MODEL} ({sp.model})")
    return sp.rank * n_local


def all_reduce(x: torch.Tensor, groups: Sequence[Any], op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced in place over each of ``groups`` (none on one rank)."""
    for group in groups:
        dist.all_reduce(x, op=op, group=group)
    return x


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, the gradient summed over
    ``model`` backward."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.groups), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the sum over ``model`` forward, into a new tensor
    (autograd may have saved ``x``), the identity backward."""

    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    """The sum over ``groups`` forward (into a new tensor), and the gradient
    summed over them backward: every rank uses the sum whole, so each rank's
    share of it takes every rank's gradient."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return all_reduce(x.clone(memory_format=torch.contiguous_format), groups)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.groups), None


def sum_over_rows(x: torch.Tensor, sp: Split) -> torch.Tensor:
    """The sum of ``x`` over the blocks of the global batch's rows (a new
    tensor), for a value that every block's loss takes whole (the MoE aux
    loss's sums): its backward sums the gradient over the blocks too, as the
    steps sum the blocks' gradients of their losses. ``x`` itself where one
    rank holds every row."""
    if not sp.row_groups:
        return x
    if not _tracked(x):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), sp.row_groups)
    return _SumOver.apply(x, sp.row_groups)


def sum_over_model(x: torch.Tensor, sp: Split) -> torch.Tensor:
    """The sum over ``model`` of each rank's partial ``x`` (a new tensor)
    for a value that every rank then uses whole on its own block (the
    gated RMSNorm's mean square over a split ``d_inner``): its backward
    sums the ranks' shares of the gradient. ``x`` itself on one rank; the
    plain all-reduce outside autograd."""
    if not sp.model_groups:
        return x
    if not _tracked(x):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), sp.model_groups)
    return _SumOver.apply(x, sp.model_groups)


def copy_to_model(x: torch.Tensor, sp: Split) -> torch.Tensor:
    """``x`` at the entry of a region split over ``model`` (Megatron's
    ``f``): itself forward; backward, its gradient summed over ``model``.
    ``x`` itself on one rank or where nothing needs its gradient."""
    if not sp.model_groups or not _tracked(x):
        return x
    return _CopyToModel.apply(x, sp.model_groups)


def reduce_from_model(x: torch.Tensor, sp: Split) -> torch.Tensor:
    """The sum over ``model`` of each rank's partial ``x`` (Megatron's ``g``),
    whose gradient is the sum's on every rank. Outside autograd the serve
    steps' in-place :func:`all_reduce`."""
    if not sp.model_groups:
        return x
    if not _tracked(x):
        return all_reduce(x, sp.model_groups)
    return _ReduceFromModel.apply(x, sp.model_groups)


def all_gather(x: torch.Tensor, sp: Split, dim: int) -> torch.Tensor:
    """The blocks of the ``model`` ranks along ``dim``, concatenated in rank
    order (``x`` itself on one rank)."""
    if not sp.model_groups:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(sp.model)]
    dist.all_gather(parts, x, group=sp.model_groups[0])
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, sp: Split, dim: int) -> torch.Tensor:
    """The sum over ``model`` of the ranks' ``x``, this rank's block of it
    along ``dim`` (one reduce-scatter)."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // sp.model,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=sp.model_groups[0])
    return out.movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    """:func:`all_gather` forward; backward, this rank's slice of the
    gradient, or, where each rank holds only its share of it (``summed``),
    the slice of the shares' sum (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, sp, dim, summed):
        ctx.sp, ctx.dim, ctx.n, ctx.summed = sp, dim, x.shape[dim], summed
        return all_gather(x, sp, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return _reduce_scatter(g, ctx.sp, ctx.dim), None, None, None
        return g.narrow(ctx.dim, ctx.sp.rank * ctx.n, ctx.n).contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """:func:`_reduce_scatter` forward; backward, the gradients of the
    ranks' blocks all-gathered (each rank's partial ``x`` reaches every
    block)."""

    @staticmethod
    def forward(ctx, x, sp, dim):
        ctx.sp, ctx.dim = sp, dim
        return _reduce_scatter(x, sp, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.sp, ctx.dim), None, None


def reduce_scatter(x: torch.Tensor, sp: Split, dim: int) -> torch.Tensor:
    """The sum over ``model`` of each rank's partial ``x``, this rank's
    block of it along ``dim``: where a product is split on its contraction
    (``w_gate``/``w_up`` of the experts on ``d_model``) and its consumer on
    another dim (``w_down`` on the experts). ``x`` itself on one rank."""
    if not sp.model_groups:
        return x
    if not _tracked(x):
        return _reduce_scatter(x, sp, dim)
    return _ReduceScatter.apply(x, sp, dim)


def all_gather_for_replicated(x: torch.Tensor, sp: Split, dim: int) -> torch.Tensor:
    """The ``model`` ranks' blocks along ``dim`` for a consumer that every
    rank computes alike (the residual stream), whose gradient is whole on
    each rank: the backward keeps this rank's slice."""
    if not sp.model_groups or not _tracked(x):
        return all_gather(x, sp, dim)
    return _AllGather.apply(x, sp, dim, False)


def all_gather_for_split(x: torch.Tensor, sp: Split, dim: int) -> torch.Tensor:
    """The ``model`` ranks' blocks along ``dim`` for a consumer split over
    ``model`` (each rank attends its own query heads over every KV head, or
    reads its own rows), whose gradient on a rank is that rank's share: the
    backward reduce-scatters the shares over ``model`` to this rank's
    slice."""
    if not sp.model_groups or not _tracked(x):
        return all_gather(x, sp, dim)
    return _AllGather.apply(x, sp, dim, True)


def gather_heads(t: torch.Tensor, n_global: int, sp: Split, dim: int = 1) -> torch.Tensor:
    """Every one of the ``n_global`` heads of ``t``, which holds this rank's
    block of them along ``dim``, or all of them."""
    if t.shape[dim] == n_global:
        return t
    return all_gather(t, sp, dim)


def embed(table: torch.Tensor, ids: torch.Tensor, vocab: int, sp: Split,
          lookup: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The vocab-parallel embedding: this rank's rows of the table looked up
    (``lookup(table, ids)``) where an id falls among them, zeros elsewhere,
    summed over ``model``; a whole table looked up as it is."""
    if table.shape[0] == vocab:
        return lookup(table, ids)
    idx = ids - offset(table.shape[0], vocab, sp)
    mine = (idx >= 0) & (idx < table.shape[0])
    x = lookup(table, idx.clamp(0, table.shape[0] - 1))
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    return reduce_from_model(x, sp)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, vocab: int,
                  sp: Split, whole: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``whole(logits, labels, mask)`` (``models/common.py:cross_entropy_loss``)
    of the whole logits (B, S, vocab) from this rank's block of their columns
    (B, S, V/model): the mean NLL over ``mask`` and the accuracy, each the
    same on every rank, and their gradient into this rank's columns;
    ``whole`` itself where the rank holds every column.

    The global max is the largest of the ranks' maxima (an all-gather of
    them, which also names the rank holding the argmax: the first rank with
    the global max, so the lowest global index, as ``argmax``); the sum of
    ``exp(l - max)``, the label's logit (from the rank whose block holds
    it), the max as added back (its gradient a one-hot at the argmax: the
    reference's fault 3, once, on that rank) and the accuracy's hit are
    summed over ``model`` in one :func:`reduce_from_model`."""
    if logits.shape[-1] == vocab:
        return whole(logits, labels, mask)
    logits32 = logits.to(torch.float32)
    top, arg = torch.max(logits32, dim=-1, keepdim=True)
    off = offset(logits.shape[-1], vocab, sp)
    idx = labels[..., None].long() - off
    tops = all_gather(top.detach()[None], sp, 0)  # (model, B, S, 1)
    m_all = tops.max(0).values
    own = torch.argmax((tops == m_all).to(torch.uint8), dim=0) == sp.rank
    sumexp = torch.sum(torch.exp(logits32 - m_all), dim=-1)
    mine = (idx >= 0) & (idx < logits.shape[-1])
    label_logit = torch.where(mine, torch.gather(logits32, -1, idx.clamp(
        0, logits.shape[-1] - 1)), 0.0)
    m = torch.where(own, top, 0.0)
    hit = (own & (arg == idx)).to(torch.float32)
    sums = reduce_from_model(torch.cat([sumexp[..., None], label_logit, m, hit], -1), sp)
    nll = torch.log(sums[..., 0]) + sums[..., 2] - sums[..., 1]
    mask = mask.to(torch.float32)
    total = torch.clamp_min(torch.sum(mask), 1.0)
    return torch.sum(nll * mask) / total, torch.sum(sums[..., 3].detach() * mask) / total


def combine(out: torch.Tensor, lse: torch.Tensor, sp: Split) -> torch.Tensor:
    """The whole cache's attention from this rank's slice partial ``out``
    (..., dv) f32 and its log-sum-exp ``lse`` (...): an all-reduce of the
    max over the ranks that split the cache, then one of the weighted
    partials and their weights (``kernels/ref.py:combine_partials`` across
    ranks). With one partial, ``out`` itself."""
    if not sp.seq_groups:
        return out
    top = all_reduce(lse.clone(), sp.seq_groups, dist.ReduceOp.MAX)
    top = torch.where(torch.isfinite(top), top, torch.zeros((), device=top.device))
    w = torch.exp(lse - top)[..., None]
    acc = all_reduce(torch.cat([out * w, w], dim=-1), sp.seq_groups)
    den = acc[..., -1:]
    return acc[..., :-1] / torch.where(den > 0, den, torch.ones((), device=den.device))


def write_row(cache: torch.Tensor, row: torch.Tensor, at: torch.Tensor, sp: Split) -> None:
    """Write ``row`` (B,KV,1,hd) at global position ``at`` (a one-element
    int64 device tensor) into this rank's slice of the cache (B,KV,rows,hd),
    in place, where the rank holds that position, with no host sync:
    elsewhere the slice's clamped row is written back unchanged."""
    row = row.to(cache.dtype)
    if not sp.seq_groups:  # the whole cache: row ``at`` is this rank's
        cache.index_copy_(2, at, row)
        return
    rows = cache.shape[2]
    local = (at - sp.kv_start).clamp(0, rows - 1)
    mine = (at >= sp.kv_start) & (at < sp.kv_start + rows)
    cache.index_copy_(2, local, torch.where(mine, row, cache.index_select(2, local)))
