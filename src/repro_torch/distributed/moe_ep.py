"""Expert-parallel MoE dispatch over an all-to-all on the ``model`` axis: the
torch twin of the JAX package's ``distributed/moe_ep.py``.

Tokens travel to their experts' owner ranks over an **all_to_all on the
model axis** (experts are model-sharded; every model column holds the same
experts for its data rows), are dispatched, computed and combined there,
then travel back by a second all_to_all. Per-rank per-layer traffic is
O(T_local·K·d), where the dense dispatch moves every expert's weights.

Correctness contract: the same routing (sigmoid top-k, renormalized gates)
and the same capacity-drop semantics as ``models/moe.py``, applied in two
stages (``Cs`` routes per destination shard, then ``C2`` per local
expert), as the reference's ``_ep_block``.

Inside the ``tp`` train step's Megatron split (:func:`_split_ep`) each
``model`` rank of a data block sends its ``1/model`` of the rows, as the
reference's ``P(all_axes)`` block, and the rows' outputs are all-gathered
back into the residual stream.

The reference's three ``lax.all_to_all``s are
``torch.distributed.nn.functional.all_to_all_single`` over the mesh's
``model`` group (the rows' one differentiable; the routing metadata's the
plain collective), and its ``pmean`` of the aux loss an all-reduce mean
over the same group. On a group of one rank they are the identity and
nothing is communicated.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models.common import activation
from ..models.config import ModelConfig
from . import tensor_parallel as tp
from .sharding import mesh_shape


def _positions_by_key(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Stable position of each element within its bucket (sort trick)."""
    n = keys.shape[0]
    order = torch.sort(keys, stable=True).indices
    sorted_k = keys[order]
    seg_start = torch.searchsorted(sorted_k, torch.arange(n_buckets, device=keys.device,
                                                          dtype=sorted_k.dtype))
    pos_sorted = torch.arange(n, device=keys.device) - seg_start[sorted_k]
    return torch.empty_like(pos_sorted).index_put_((order,), pos_sorted)


def _all_to_all(x: torch.Tensor, group: Any, differentiable: bool) -> torch.Tensor:
    """Row block i of ``x`` (n, ...) to rank i of ``group``; block i of the
    result came from rank i (the reference's ``all_to_all(split_axis=0,
    concat_axis=0, tiled=False)``)."""
    if group is None:
        return x
    x = x.contiguous()
    if differentiable:
        from torch.distributed.nn.functional import all_to_all_single

        return all_to_all_single(torch.empty_like(x), x, group=group)
    import torch.distributed as dist

    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _pmean(x: torch.Tensor, group: Any) -> torch.Tensor:
    if group is None:
        return x
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, op=dist.ReduceOp.SUM, group=group) / dist.get_world_size(group)


def _ep_block(x_loc, router_w, w_gate, w_up, w_down, *, cfg: ModelConfig, n_shards: int,
              group: Any = None, logits: Optional[torch.Tensor] = None,
              aux_mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank body. x_loc (Tl, d); expert weights are the LOCAL slices
    (E_loc, d, ffe); ``group`` the ``model`` axis' process group (None for
    one shard). Returns (y_loc (Tl, d), aux 0-d f32). ``logits`` (Tl, E):
    the router's, where the caller computed them (``router_w`` unused);
    ``aux_mean``: the aux loss's mean over ``group`` (its ``pmean``)."""
    m = cfg.moe
    Tl, d = x_loc.shape
    E, K = m.n_experts, m.top_k
    E_loc = E // n_shards
    act = activation(cfg.mlp_act)
    dev = x_loc.device

    # ---- routing (full router replicated: E scores per local token) --------
    if logits is None:
        logits = x_loc @ router_w.to(x_loc.dtype)
    logits = logits.to(torch.float32)
    scores = torch.sigmoid(logits) if m.router == "sigmoid" else torch.softmax(logits, -1)
    gates, idx = torch.topk(scores, K, dim=-1)
    gates = (gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)).to(x_loc.dtype)
    probs = scores / torch.clamp_min(scores.sum(-1, keepdim=True), 1e-9)
    assign = torch.zeros_like(probs).scatter_add_(1, idx, torch.ones_like(idx, dtype=probs.dtype))
    aux = torch.mean(probs.mean(0) * assign.mean(0)) * (E ** 2) * m.aux_loss_coef
    aux = aux_mean(aux) if aux_mean else _pmean(aux, group)

    # ---- stage 1: send routes to expert-owner shards ------------------------
    flat_e = idx.reshape(-1)                      # (Tl*K,) global expert id
    dest = flat_e // E_loc                        # owner shard on the model axis
    Cs = max(1, int(math.ceil(Tl * K / n_shards * m.capacity_factor)))
    pos_in_dest = _positions_by_key(dest, n_shards)
    keep1 = pos_in_dest < Cs
    slot1 = torch.where(keep1, dest * Cs + pos_in_dest, n_shards * Cs)

    flat_tok = torch.arange(Tl * K, device=dev) // K
    n1 = n_shards * Cs + 1
    tok_for_slot = torch.full((n1,), Tl, dtype=torch.int64, device=dev).index_put_(
        (slot1,), flat_tok)[:-1]
    eloc_for_slot = torch.zeros((n1,), dtype=torch.int64, device=dev).index_put_(
        (slot1,), flat_e % E_loc)[:-1]
    occupied = torch.zeros((n1,), dtype=torch.int64, device=dev).index_put_(
        (slot1,), keep1.to(torch.int64))[:-1]

    x_pad = torch.cat([x_loc, x_loc.new_zeros((1, d))], 0)
    send = x_pad[tok_for_slot].view(n_shards, Cs, d)
    send_meta = torch.stack([eloc_for_slot, occupied], dim=-1).view(n_shards, Cs, 2)

    recv = _all_to_all(send, group, differentiable=True)
    recv_meta = _all_to_all(send_meta, group, differentiable=False)
    # recv: (n_shards, Cs, d) — block i came from source shard i
    rows = recv.reshape(n_shards * Cs, d)
    r_eloc = recv_meta.reshape(-1, 2)[:, 0]
    r_occ = recv_meta.reshape(-1, 2)[:, 1] > 0

    # ---- stage 2: local per-expert dispatch --------------------------------
    R = rows.shape[0]
    C2 = max(1, int(math.ceil(R / E_loc * m.capacity_factor)))
    key2 = torch.where(r_occ, r_eloc, E_loc)  # unoccupied rows -> overflow bucket
    pos2 = _positions_by_key(key2, E_loc + 1)
    keep2 = (pos2 < C2) & r_occ
    slot2 = torch.where(keep2, r_eloc * C2 + pos2, E_loc * C2)

    row_for_slot = torch.full((E_loc * C2 + 1,), R, dtype=torch.int64, device=dev).index_put_(
        (slot2,), torch.arange(R, device=dev))[:-1]
    rows_pad = torch.cat([rows, rows.new_zeros((1, d))], 0)
    buf = rows_pad[row_for_slot].view(E_loc, C2, d)

    g = torch.bmm(buf, w_gate.to(buf.dtype))
    u = torch.bmm(buf, w_up.to(buf.dtype))
    y_buf = torch.bmm(act(g) * u, w_down.to(buf.dtype)).reshape(E_loc * C2, d)
    y_buf = torch.cat([y_buf, y_buf.new_zeros((1, d))], 0)

    y_rows = y_buf[slot2] * keep2[:, None].to(y_buf.dtype)  # (n_shards*Cs, d)

    # ---- return trip + combine ----------------------------------------------
    y_recv = _all_to_all(y_rows.view(n_shards, Cs, d), group, differentiable=True)
    y_flat = torch.cat([y_recv.reshape(n_shards * Cs, d), y_recv.new_zeros((1, d))], 0)
    yk = y_flat[slot1] * (gates.reshape(-1, 1) * keep1[:, None].to(y_recv.dtype))
    y_loc = yk.view(Tl, K, d).sum(1)
    return y_loc, aux


def _local_experts(w: torch.Tensor, n_shards: int, rank: int) -> torch.Tensor:
    """This rank's experts (E/n, ...): rows ``rank·E/n ..`` of a plain
    tensor (a sharded model's experts are the split's:
    :func:`_split_ep`)."""
    e = w.shape[0] // n_shards
    return w[rank * e:(rank + 1) * e]


def moe_ffn_ep(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
               mesh: Any, sp: Optional[tp.Split] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE. ``x`` (B, S, d) is this rank's block of the
    batch (the step splits the batch over every mesh axis, as the
    reference's ``P(all_axes)`` does); the expert weights are plain whole
    tensors, of which this rank takes its slice, as are the router and the
    shared experts. With a step's Megatron split ``sp`` (the ``tp`` train
    step's, whose weights are ``DTensor`` blocks), :func:`_split_ep`."""
    if sp is not None:
        return _split_ep(p, x, cfg, sp)
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    n_shards = mesh_shape(mesh)["model"]
    if m.n_experts % n_shards:
        raise ValueError(f"moe_ffn_ep: {m.n_experts} experts do not split over "
                         f"{n_shards} model ranks")
    group: Optional[Any] = mesh.get_group("model") if n_shards > 1 else None
    rank = mesh.get_local_rank("model")
    wg, wu, wd = (_local_experts(p[k], n_shards, rank) for k in ("w_gate", "w_up", "w_down"))

    x2d = x.reshape(T, d)
    # chunk loop inside the block: weights enter once, buffers stay chunk-sized
    nc = m.dispatch_chunks if (m.dispatch_chunks > 1 and T % m.dispatch_chunks == 0) else 1
    if nc == 1:
        y2d, aux = _ep_block(x2d, p["router"], wg, wu, wd, cfg=cfg, n_shards=n_shards,
                             group=group)
    else:
        ys, auxes = zip(*(_ep_block(xc, p["router"], wg, wu, wd, cfg=cfg, n_shards=n_shards,
                                    group=group) for xc in x2d.view(nc, T // nc, d)))
        y2d, aux = torch.cat(ys), torch.stack(auxes).mean()

    y = y2d.view(B, S, d)
    if m.n_shared:
        act = activation(cfg.mlp_act)
        sg = x @ p["shared_gate"].to(x.dtype)
        su = x @ p["shared_up"].to(x.dtype)
        y = y + (act(sg) * su) @ p["shared_down"].to(x.dtype)
    return y, aux


def _split_ep(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              sp: tp.Split) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel FFN inside the ``tp`` train step's Megatron split.
    ``x`` (B, S, d) is whole on every ``model`` rank (its ``data`` block);
    each rank takes its ``1/model`` of the rows (the reference's
    ``P(all_axes)`` block), routes them by the logits of the router's
    blocks (all-gathered over ``model``, each rank reading its rows), runs
    :func:`_ep_block` on the experts ``w_*`` split over ``model`` on their
    dim 0 (``tensor_parallel.weight(experts=True)``), and the rows' outputs
    are all-gathered back over ``model``; the aux loss is the ranks' mean
    (a ``reduce_from_model``: every rank's loss holds it), and the shared
    experts are column- and row-parallel, summed by one ``reduce_from_model``."""
    m = cfg.moe
    B, S, d = x.shape
    T, n = B * S, sp.model
    if m.n_experts % n or T % n:
        raise ValueError(f"moe_ffn_ep: {m.n_experts} experts and {T} rows do not split over "
                         f"{n} model ranks")
    w = [tp.weight(p[k], experts=True) for k in ("w_gate", "w_up", "w_down")]
    ffs = m.d_ff_expert * m.n_shared
    if n > 1 and (p["router"].shape[-1] == m.n_experts or w[0].shape[0] == m.n_experts or
                  m.n_shared and p["shared_down"].shape[0] == ffs):
        raise NotImplementedError("the split's expert-parallel FFN takes the router, the experts "
                                  "and the shared experts split over model")
    xf = tp.copy_to_model(x.reshape(T, d), sp)  # each rank's rows and columns: shares
    logits = tp.all_gather_for_split(xf @ p["router"].to(x.dtype), sp, dim=1)
    rows = T // n
    x_loc, l_loc = xf.narrow(0, sp.rank * rows, rows), logits.narrow(0, sp.rank * rows, rows)
    group = sp.model_groups[0] if sp.model_groups else None

    def mean(aux):
        return tp.reduce_from_model(aux, sp) / n if sp.model_groups else aux
    kw = dict(cfg=cfg, n_shards=n, group=group, aux_mean=mean)
    nc = m.dispatch_chunks if (m.dispatch_chunks > 1 and rows % m.dispatch_chunks == 0) else 1
    if nc == 1:
        y_loc, aux = _ep_block(x_loc, None, *w, logits=l_loc, **kw)
    else:
        ys, auxes = zip(*(_ep_block(xc, None, *w, logits=lc, **kw) for xc, lc in
                          zip(x_loc.view(nc, rows // nc, d), l_loc.view(nc, rows // nc, -1))))
        y_loc, aux = torch.cat(ys), torch.stack(auxes).mean()
    y = tp.all_gather_for_replicated(y_loc, sp, dim=0)
    if m.n_shared:
        act = activation(cfg.mlp_act)
        sg = xf @ p["shared_gate"].to(x.dtype)
        su = xf @ p["shared_up"].to(x.dtype)
        y = y + tp.reduce_from_model((act(sg) * su) @ p["shared_down"].to(x.dtype), sp)
    return y.view(B, S, d), aux
