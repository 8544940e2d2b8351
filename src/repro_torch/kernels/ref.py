"""Plain PyTorch versions of the package's kernels: what each kernel computes,
written with no code shared with the kernel, so the tests catch a kernel
that computes something else. The CPU path of every wrapper runs these."""

from __future__ import annotations

import torch


def dequant_u8_ref(x, scale, bias, out_dtype=torch.float32):
    """``(x * scale + bias)`` over the last axis of ``x``: float32 multiply,
    then float32 add (two separately rounded ops, as numpy's host decode),
    then one round to ``out_dtype``."""
    prod = x.to(torch.float32) * scale
    return (prod + bias).to(out_dtype)


NEG_INF = -1e30  # the TPU kernels' mask value (not -inf)


def _softmax_av(s, ok, v):
    """Masked softmax of f32 scores ``s`` over the last axis, then ``@ v``."""
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32))


def _live(Sq, Sk, causal, window, device):
    """(Sq, Sk) mask of the (query, key) pairs the attention keeps."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return ok


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None, return_lse=False):
    """q (B,H,Sq,hd), k/v (B,KV,Sk,hd) -> (B,H,Sq,hd) in q's dtype.
    Materializes the (Sq, Sk) scores in f32; q head h reads KV head
    ``h // (H // KV)``. ``causal`` keeps ``kpos <= qpos`` (both from 0),
    ``window > 0`` also ``kpos > qpos - window``. With ``return_lse`` also
    each row's log-sum-exp of its masked, scaled scores (B,H,Sq) in f32."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    kf = k.to(torch.float32).repeat_interleave(g, dim=1)
    vf = v.repeat_interleave(g, dim=1)
    s = torch.matmul(q.to(torch.float32), kf.transpose(-1, -2)) * scale
    ok = _live(Sq, Sk, causal, window, q.device)
    out = _softmax_av(s, ok, vf).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s.masked_fill(~ok, NEG_INF), dim=-1)
    return out


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, window=0, scale=None):
    """The gradient of ``flash_attention_ref`` by the FlashAttention-2
    formulas, with ``o`` its output, ``do`` the output's gradient and ``lse``
    its log-sum-exp (Sq = Sk)::

        P = exp(scale·Q Kᵀ − lse) (0 where masked)    D = rowsum(dO ∘ O)
        dV = Pᵀ dO    dS = P ∘ (dO Vᵀ − D)    dQ = scale·dS K    dK = scale·dSᵀ Q

    in f32, dK and dV summed over each KV head's group of q heads; returns
    (dq, dk, dv) in the inputs' dtypes."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qf, dof = q.to(torch.float32), do.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(g, dim=1)
    vf = v.to(torch.float32).repeat_interleave(g, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    ok = _live(S, S, causal, window, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    d = (dof * o.to(torch.float32)).sum(-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - d)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.reshape(B, KV, g, S, hd).sum(2)
    dv = dv.reshape(B, KV, g, S, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q, k, v, pos, *, window=0, scale=None):
    """q (B,KV,g,hd), k/v (B,KV,S,hd), ``pos`` an int or a 0-d integer tensor
    (on any device) -> (B,KV,g,hd) in q's dtype. Cache rows ``<= pos`` are
    live; ``window > 0`` also needs ``kpos > pos - window``."""
    hd = q.shape[-1]
    S = k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    kpos = torch.arange(S, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    ok = kpos <= pos
    if window > 0:
        ok &= kpos > pos - window
    return _softmax_av(s, ok, v).to(q.dtype)


def ssd_scan_ref(x, dtA, Bm, Cm, *, chunk=128):
    """Mamba2's SSD scan in its chunked dual form, in the kernel's layout:
    x (B,H,L,P), dtA (B,H,L), Bm/Cm (B,L,N) shared over heads -> (y
    (B,H,L,P) in x's dtype, final state (B,H,P,N) in f32).

    Per chunk of Q = ``chunk`` steps (``L % Q == 0``), with Acs the inclusive
    cumsum of dtA inside the chunk::

        y     = ((C Bᵀ) ⊙ L) x + (C stateᵀ) ⊙ exp(Acs)
        state = state · exp(Acs_Q) + (x ⊙ exp(Acs_Q - Acs))ᵀ B

    with ``L[i, j] = exp(Acs_i - Acs_j)`` masked to the lower triangle before
    the exp (-1e9 above it), and the state starting at zero. Everything is
    f32, as in the TPU kernel (``src/repro/kernels/ssd_scan.py:_kernel``: its
    ``.astype(x.dtype)`` at line 52 casts to its f32 copy of x, so it rounds
    nothing); only y is rounded, once, to x's dtype. The chunks' own states
    come from one einsum and are carried across chunks by a loop."""
    B, H, L, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError(f"ssd_scan: L={L} is not a multiple of chunk={chunk}")
    nc, Q = L // chunk, chunk
    xf = x.float().reshape(B, H, nc, Q, P)
    acs = torch.cumsum(dtA.float().reshape(B, H, nc, Q), dim=-1)
    Bf = Bm.float().reshape(B, nc, Q, N)
    Cf = Cm.float().reshape(B, nc, Q, N)

    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    diff = (acs[..., :, None] - acs[..., None, :]).masked_fill(~tri, -1e9)
    scores = torch.einsum("bcin,bcjn->bcij", Cf, Bf)
    y_diag = torch.einsum("bhcij,bhcjp->bhcip", scores[:, None] * torch.exp(diff), xf)

    last = acs[..., -1]  # (B,H,nc)
    own = torch.einsum("bhcjp,bhcj,bcjn->bhcpn", xf, torch.exp(last[..., None] - acs), Bf)
    state = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * torch.exp(last[:, :, c])[..., None, None] + own[:, :, c]
    y_off = torch.einsum("bcin,bhcpn->bhcip", Cf, torch.stack(starts, dim=2))
    y = y_diag + y_off * torch.exp(acs)[..., None]
    return y.reshape(B, H, L, P).to(x.dtype), state
