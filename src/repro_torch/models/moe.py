"""Mixture-of-Experts FFN (DeepSeek-V3 / Kimi-K2): the torch twin of the JAX
package's ``models/moe.py``, the same algorithm step for step.

Routing: router logits in the activations' dtype, then f32; sigmoid (or
softmax) scores, top-k, the selected gates renormalized, plus the
Switch-style auxiliary load-balancing loss, returned as the reference
returns it (serving ignores it).

Dispatch: capacity-bounded scatter dispatch. Each (token, k) route gets its
position in its expert's queue from a stable sort of the flat expert ids,
tokens past ``C = ceil(T·K/E · capacity_factor)`` are dropped, the kept
tokens are gathered into an (E, C, d) buffer (empty slots read a zero
row), the experts run as dense batched products (``torch.bmm``: the
reference's ``einsum``s, which XLA computes, not a Pallas kernel), and the
results come back weighted by ``gate · keep``, plus the shared expert.
With ``dispatch_chunks`` > 1 (and T a multiple of it) the tokens go
through in that many chunks, each with its own capacity, in a Python loop
where the reference runs ``lax.scan``; the aux loss is the chunks' mean
(``_rows_dispatch``).

Under autograd the gradients are the reference's: through top-k's values
into the router, through the renormalization of the selected gates (a
dropped route's gate included), through the aux loss's ``probs`` (not its
assignment counts), and none through the slot a dropped route reads. The
two index ops between tokens and slots (tokens into the (E, C, d) buffer,
the experts' rows back to the routes) are ``_Gather``: a gather whose
gradient is a gather too, each row summed over a fixed list in a fixed
order, so two backward passes give bit-equal gradients (the index ops'
own backward may accumulate into repeated rows in an unfixed order on the
card). The slot map is one-to-one for kept routes, which makes both
gradients gathers.

Every expert is computed for every chunk, also one that no token of the
chunk chose: the reference's dense dispatch, kept for its exact drops and
outputs (ROADMAP.md lists skipping empty experts as open). Under rules
that set ``_moe_ep`` (a train step's ``moe_ep=True``) the FFN is the
expert-parallel dispatch of ``distributed/moe_ep.py`` instead, as the
reference's ``moe_ffn`` branches.

Under a step's Megatron split (``sp``: the serve steps' and the ``tp``
train step's) the FFN runs on this rank's blocks, as
``partition.param_specs`` stores them: the router on the experts,
``w_gate``/``w_up`` (E, d, ffe) on ``d_model``, ``w_down`` on the experts,
the shared experts on their width. The input enters through Megatron's
``f``; the router's logits are all-gathered, so every ``model`` rank routes
its rows alike (the same capacity ``C``, the same drops, the same aux loss,
once in every rank's loss); the slots hold this rank's columns of
``d_model``, whose gate and up products are partial sums, reduce-scattered
to ``w_down``'s experts; the routes of those experts come back (the others
read the zero row) with the gates through ``f``, and the routed and shared
experts' partial outputs are summed by one ``reduce_from_model``. On whole
weights (``tp.ONE``) it is the dispatch above, op for op.

Where the rows of ``x`` are one block of the global batch (``sp.row_blocks``
> 1: the split steps' ``data`` ranks, every rank in the ``dp`` step) the
dispatch is still the global batch's, as the reference's ``moe_ffn`` is
under ``jit`` (``_rows_dispatch``): the chunks are the global tokens', each
with a global chunk's capacity, and the aux loss is the mean over all of
them, from sums over the blocks. With one block it is the dispatch above,
op for op.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..distributed import tensor_parallel as tp
from .common import Initializer, activation
from .config import ModelConfig


def init_moe(ini: Initializer, cfg: ModelConfig) -> Dict[str, Any]:
    m = cfg.moe
    d, ffe, E = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {
        "router": ini.normal((d, E), scale=0.006),
        "w_gate": ini.fanin((E, d, ffe)),
        "w_up": ini.fanin((E, d, ffe)),
        "w_down": ini.fanin((E, ffe, d)),
    }
    if m.n_shared:
        ffs = ffe * m.n_shared
        p["shared_gate"] = ini.fanin((d, ffs))
        p["shared_up"] = ini.fanin((d, ffs))
        p["shared_down"] = ini.fanin((ffs, d))
    return p


class _Gather(torch.autograd.Function):
    """``cat([src, 0])[index]``: rows of ``src`` (N, d), ``index`` N for a
    zero row. Its gradient is a gather as well: row n of ``src``'s gradient
    is the sum over j of row ``back[n, j]`` of the output's gradient, where
    ``back`` (N, J) lists the output rows that read row n (one past the
    output's last row where a row has fewer than J), summed in that order."""

    @staticmethod
    def forward(ctx, src, index, back):
        ctx.save_for_backward(back)
        return torch.cat([src, src.new_zeros((1, src.shape[1]))])[index]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (back,) = ctx.saved_tensors
        pad = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        return pad[back].sum(1), None, None


def _scores(p, x2d: torch.Tensor, cfg: ModelConfig, sp: tp.Split = tp.ONE
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(top-k expert ids (T, K), their renormalized gates (T, K) f32, each
    token's probs over the experts (T, E) f32, the aux loss's). A router
    block of this rank's experts' columns (``sp``) gives their logits,
    all-gathered before the routing, so that every ``model`` rank routes
    alike."""
    m = cfg.moe
    logits = x2d @ p["router"].to(x2d.dtype)
    if logits.shape[-1] != m.n_experts:
        logits = tp.all_gather_for_replicated(logits, sp, dim=1)
    logits = logits.to(torch.float32)
    if m.router == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(scores, m.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    probs = scores / torch.clamp_min(scores.sum(-1, keepdim=True), 1e-9)
    return idx, gates, probs


def route(p, x2d: torch.Tensor, cfg: ModelConfig, sp: tp.Split = tp.ONE
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(top-k expert ids (T, K), gates (T, K) in x's dtype, aux loss 0-d f32)
    of one dispatch chunk's tokens ``x2d``, the aux loss from their means."""
    m = cfg.moe
    idx, gates, probs = _scores(p, x2d, cfg, sp)
    # Switch aux loss: mean prob per expert * mean assignment per expert
    assign = torch.zeros_like(probs).scatter_add_(1, idx, torch.ones_like(gates))
    aux = torch.mean(probs.mean(0) * assign.mean(0)) * (m.n_experts ** 2)
    return idx, gates.to(x2d.dtype), aux * m.aux_loss_coef


def _split_blocks(p, cfg: ModelConfig) -> bool:
    """True where the layer's blocks are split over ``model`` (the router
    on the experts, ``w_gate``/``w_up`` on ``d_model``, ``w_down`` on the
    experts, the shared experts on their width), False where all are
    whole."""
    m = cfg.moe
    cut = [p["router"].shape[-1] != m.n_experts, p["w_gate"].shape[1] != cfg.d_model,
           p["w_up"].shape[1] != cfg.d_model, p["w_down"].shape[0] != m.n_experts]
    if m.n_shared:
        cut.append(p["shared_down"].shape[0] != m.d_ff_expert * m.n_shared)
    if any(cut) and not all(cut):
        raise NotImplementedError(
            f"the MoE split takes the router, the experts and the shared experts all split over "
            f"model or all whole; these blocks are {[tuple(p[k].shape) for k in sorted(p)]}")
    return all(cut)


def _capacity(T: int, cfg: ModelConfig) -> int:
    """Slots an expert has in a dispatch chunk of ``T`` tokens."""
    m = cfg.moe
    return max(1, int(math.ceil(T * m.top_k / m.n_experts * m.capacity_factor)))


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, sp: Optional[tp.Split] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, d) -> ((B, S, d), aux loss). Under a step's split ``sp`` on
    this rank's blocks: ``x`` enters through Megatron's ``f``, every rank
    routes alike, and the routed and shared experts' partial outputs leave
    through one ``reduce_from_model``. Where ``x``'s rows are one of
    ``sp.row_blocks`` blocks of the global batch, the dispatch is still the
    global batch's (:func:`_rows_dispatch`)."""
    from ..distributed import sharding

    sp = sp or tp.ONE
    if sharding.moe_ep_active():
        from ..distributed.moe_ep import moe_ffn_ep

        return moe_ffn_ep(p, x, cfg, sharding._mesh(), sp if sp.mesh is not None else None)
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    split = _split_blocks(p, cfg)
    if split:
        x2d = tp.copy_to_model(x2d, sp)
    y, aux = _rows_dispatch(p, x2d, cfg, sp, split)
    if split:
        y = tp.reduce_from_model(y, sp)
    return y.view(B, S, d), aux


def _segments(T: int, sp: tp.Split, cfg: ModelConfig) -> Tuple[int, int, list]:
    """(the reference's chunk count ``nc`` over the global batch, its chunk
    size, and this block's segments ``(chunk, lo, hi)``: local rows
    ``[lo, hi)`` are the part of global chunk ``chunk`` that this block
    holds). Global token = block index × ``T`` + local index."""
    m = cfg.moe
    Tg = T * sp.row_blocks
    nc = m.dispatch_chunks if (m.dispatch_chunks > 1 and Tg % m.dispatch_chunks == 0) else 1
    Tc, start = Tg // nc, sp.row_block * T
    segs = [(c, max(c * Tc, start) - start, min((c + 1) * Tc, start + T) - start)
            for c in range(start // Tc, (start + T - 1) // Tc + 1)]
    return nc, Tc, segs


def _rows_dispatch(p, x2d: torch.Tensor, cfg: ModelConfig, sp: tp.Split, split: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dispatch of the global batch, from this rank's block
    of its rows ``x2d`` (T, d), the whole batch where one rank holds every
    row: the chunks are the global tokens', each with the capacity of a
    global chunk, and the aux loss is the mean over every chunk. Where each
    block holds whole chunks (always, with one block), it runs them as one
    rank would and averages the blocks' aux losses (one all-reduce). Where a
    chunk spans blocks, each route's queue position counts the routes to its
    expert on lower blocks of its chunk (per-(chunk, expert) counts summed
    over the blocks, no gradient), and the aux loss's two means come from
    the chunks' sums over the blocks, its probs' through
    ``tp.sum_over_rows``, whose backward sums the gradient over the blocks'
    losses. Counts and positions stay on the device."""
    m = cfg.moe
    T, d = x2d.shape
    E = m.n_experts
    nc, Tc, segs = _segments(T, sp, cfg)
    if all(hi - lo == Tc for _, lo, hi in segs):  # whole chunks
        ys, auxes = zip(*(_moe_tokens(p, x2d[lo:hi], cfg, sp, split) for _, lo, hi in segs))
        y = ys[0] if len(ys) == 1 else torch.cat(ys)
        return y, tp.sum_over_rows(torch.stack(auxes).mean(), sp) / sp.row_blocks
    idx, gates, probs = _scores(p, x2d, cfg, sp)
    dev = x2d.device
    counts = torch.zeros((sp.row_blocks, nc, E), dtype=torch.int64, device=dev)
    zero = probs.new_zeros(E)
    psums = [zero] * nc
    for c, lo, hi in segs:
        flat = idx[lo:hi].reshape(-1)
        counts[sp.row_block, c].index_add_(0, flat, torch.ones_like(flat))
        psums[c] = probs[lo:hi].sum(0)
    counts = tp.all_reduce(counts, sp.row_groups)  # every block's counts
    below = counts[:sp.row_block].sum(0)  # (nc, E): routes on lower blocks
    psum = tp.sum_over_rows(torch.stack(psums), sp)
    assign = counts.sum(0).to(torch.float32)
    aux = torch.mean((psum / Tc) * (assign / Tc), dim=1) * (E ** 2)
    C = _capacity(Tc, cfg)
    gates = gates.to(x2d.dtype)
    ys = [_dispatch(p, x2d[lo:hi], idx[lo:hi], gates[lo:hi], cfg, sp, split, C, below[c])[0]
          for c, lo, hi in segs]
    return torch.cat(ys), aux.mean() * m.aux_loss_coef


def _experts(p, buf: torch.Tensor, cfg: ModelConfig, sp: tp.Split, split: bool) -> torch.Tensor:
    """The routed experts over their slots ``buf`` (E, C, d'): the outputs
    (E', C, d) of the experts of ``w_down``'s block. Split, ``buf`` holds
    this rank's columns of ``d_model``, so the gate and up products are
    partial sums over them, reduce-scattered to this rank's experts."""
    act = activation(cfg.mlp_act)
    g = torch.bmm(buf, p["w_gate"].to(buf.dtype))
    u = torch.bmm(buf, p["w_up"].to(buf.dtype))
    if split:
        g, u = tp.reduce_scatter(g, sp, 0), tp.reduce_scatter(u, sp, 0)
    return torch.bmm(act(g) * u, p["w_down"].to(buf.dtype))


def _moe_tokens(p, x2d: torch.Tensor, cfg: ModelConfig, sp: tp.Split = tp.ONE,
                split: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of T tokens (T, d) through the routed and shared experts;
    ``split``: on this rank's blocks, the output its partial sum."""
    idx, gates, aux = route(p, x2d, cfg, sp)  # (T, K)
    return _dispatch(p, x2d, idx, gates, cfg, sp, split, _capacity(x2d.shape[0], cfg))[0], aux


def _dispatch(p, x2d: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor, cfg: ModelConfig,
              sp: tp.Split, split: bool, C: int, below: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tokens ``x2d`` (T, d) routed to ``idx`` (T, K) with ``gates``
    through the routed experts, ``C`` slots each, and the shared experts:
    (the output (T, d), which routes were kept (T·K,)). ``below`` (E,): the
    routes to each expert that come before these tokens' in their chunk
    (on lower row blocks); their queue positions start there."""
    m = cfg.moe
    T, d = x2d.shape
    E, K = m.n_experts, m.top_k
    dev = x2d.device

    # position of each (token, k) in its expert's queue, by a stable sort
    flat_e = idx.reshape(-1)  # (T*K,), token-major
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_sorted = torch.arange(T * K, device=dev) - seg_start[sorted_e]
    pos_in_e = torch.empty_like(pos_sorted).index_put_((order,), pos_sorted)
    if below is not None:
        pos_in_e = pos_in_e + below[flat_e]
    keep = pos_in_e < C
    slot = torch.where(keep, flat_e * C + pos_in_e, E * C)  # a dropped route: the extra slot

    # slot -> token (T: the zero row) and slot -> route (T*K: none); only the extra
    # slot is written more than once, and dropped. A token's gradient sums its K
    # routes' slots (the extra one reads zeros), a slot's is its route's.
    routes = torch.arange(T * K, device=dev)
    tok_for_slot = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    tok_for_slot = tok_for_slot.index_put_((slot,), routes // K)[:-1]
    route_for_slot = torch.full((E * C + 1,), T * K, dtype=torch.int64, device=dev)
    route_for_slot = route_for_slot.index_put_((slot,), routes)[:-1]
    xs = x2d
    if split:  # this rank's columns of d_model, w_gate's and w_up's block
        dg = p["w_gate"].shape[1]
        xs = x2d.narrow(1, tp.offset(dg, d, sp), dg)
    buf = _Gather.apply(xs, tok_for_slot, slot.view(T, K)).view(E, C, xs.shape[1])

    # every expert over its C slots, as dense batched products
    y_buf = _experts(p, buf, cfg, sp, split)
    e_own = y_buf.shape[0]  # w_down's experts
    y_buf = y_buf.view(e_own * C, d)

    # back to the tokens (a dropped route reads the zero row), weighted by gate and keep;
    # split, the routes of this rank's experts (the others read the zero row), and the
    # gates' gradient, each rank's experts' share, summed over model
    back = route_for_slot
    if split:
        lo, n = tp.offset(e_own, E, sp) * C, e_own * C
        slot = torch.where((slot >= lo) & (slot < lo + n), slot - lo, n)
        back = route_for_slot[lo:lo + n]
        gates = tp.copy_to_model(gates, sp)
    yk = _Gather.apply(y_buf, slot, back[:, None])
    yk = yk * (gates.reshape(-1, 1) * keep[:, None].to(x2d.dtype))
    y = yk.view(T, K, d).sum(1)

    if m.n_shared:
        act = activation(cfg.mlp_act)
        sg = x2d @ p["shared_gate"].to(x2d.dtype)
        su = x2d @ p["shared_up"].to(x2d.dtype)
        y = y + (act(sg) * su) @ p["shared_down"].to(x2d.dtype)
    return y, keep
