"""The Megatron split of the serve steps over the mesh's ``model`` axis,
and the split-S combine of context-parallel decode: plain functions on
tensors over the mesh's process groups.

The reference has no such module: GSPMD writes this for it from the spec
tables (``partition.param_specs``, ``steps.cache_spec_tree``), which fix
what each rank holds. Inside a serve step (``steps.make_prefill_step``/
``make_decode_step``, dense and vlm families) a rank computes on the
blocks it stores and moves only activations:

* **weights** are the local blocks of their ``DTensor``s, split over
  ``model`` on heads, ``head_dim``, ``d_ff`` or vocab, or whole where the
  dim does not divide (a block's shape says which: :func:`offset`);
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
  log-sum-exps, then one of the weighted sums.

A serve step hands its :class:`Split` to the model's ``prefill``/
``decode_step`` (``split=``). Without one, a GQA model computes under
:data:`ONE`, the split of one rank: its blocks are the whole weights and
cache, every collective is the identity and the combine of one partial
returns it, so a step on a one-rank mesh and the model's own call run the
same code.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding import is_dtensor

MODEL = "model"


class Split(NamedTuple):
    """What a rank needs to compute its part of a serve step.

    ``model``/``rank``: the size of the mesh's ``model`` axis and this
    rank's coordinate on it; ``kv_start``/``rows``: the global position of
    this rank's first cache row and how many it holds; ``model_groups``/
    ``seq_groups``: the process groups of ``model`` and of the mesh axes
    that split the cache's sequence (the combine's), those of more than one
    rank only, so that a step looks none up."""

    model: int
    rank: int
    kv_start: int = 0
    rows: int = 0
    model_groups: Tuple[Any, ...] = ()
    seq_groups: Tuple[Any, ...] = ()


def _groups(mesh, axes: Sequence[str]) -> Tuple[Any, ...]:
    names = list(mesh.mesh_dim_names)
    return tuple(mesh.get_group(a) for a in axes
                 if a in names and mesh.size(names.index(a)) > 1)


def make_split(mesh, *, seq_axes: Sequence[str] = (), kv_start: int = 0,
               rows: int = 0) -> Split:
    names = list(mesh.mesh_dim_names)
    if MODEL in names:
        k = names.index(MODEL)
        model, rank = mesh.size(k), mesh.get_coordinate()[k]
    else:
        model, rank = 1, 0
    return Split(model, rank, kv_start, rows, _groups(mesh, (MODEL,)),
                 _groups(mesh, seq_axes))


#: one rank: whole weights and cache, no collective
ONE = Split(1, 0)


def local(x: Any) -> torch.Tensor:
    """The block this rank stores: a ``DTensor``'s local tensor, a plain
    tensor itself."""
    return x.to_local() if is_dtensor(x) else x


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


def all_gather(x: torch.Tensor, sp: Split, dim: int) -> torch.Tensor:
    """The blocks of the ``model`` ranks along ``dim``, concatenated in rank
    order (``x`` itself on one rank)."""
    if not sp.model_groups:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(sp.model)]
    dist.all_gather(parts, x, group=sp.model_groups[0])
    return torch.cat(parts, dim=dim)


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
    return all_reduce(x, sp.model_groups)


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
