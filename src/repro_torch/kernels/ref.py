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


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None, return_lse=False,
                        out_dtype=None):
    """q (B,H,Sq,hd), k/v (B,KV,Sk,hd) -> (B,H,Sq,hd) in ``out_dtype``
    (default q's dtype). Materializes the (Sq, Sk) scores in f32; q head h
    reads KV head ``h // (H // KV)``. ``causal`` keeps ``kpos <= qpos`` (both
    from 0), ``window > 0`` also ``kpos > qpos - window``. With
    ``return_lse`` also each row's log-sum-exp of its masked, scaled scores
    (B,H,Sq) in f32."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    kf = k.to(torch.float32).repeat_interleave(g, dim=1)
    vf = v.repeat_interleave(g, dim=1)
    s = torch.matmul(q.to(torch.float32), kf.transpose(-1, -2)) * scale
    ok = _live(Sq, Sk, causal, window, q.device)
    out = _softmax_av(s, ok, vf).to(out_dtype or q.dtype)
    if return_lse:
        return out, torch.logsumexp(s.masked_fill(~ok, NEG_INF), dim=-1)
    return out


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, window=0, scale=None):
    """The gradient of ``flash_attention_ref`` by the FlashAttention-2
    formulas, with ``o`` its output (in f32 before any rounding, for D to be
    exact), ``do`` the output's gradient and ``lse`` its log-sum-exp; q
    (B,H,Sq,dk), k (B,KV,Sk,dk), v (B,KV,Sk,dv), o/do (B,H,Sq,dv), lse
    (B,H,Sq)::

        P = exp(scale·Q Kᵀ − lse) (0 where masked)    D = rowsum(dO ∘ O)
        dP = dO Vᵀ    dV = Pᵀ dO    dS = P ∘ (dP − D)    dQ = scale·dS K
        dK = scale·dSᵀ Q

    in f32, dK and dV summed over each KV head's group of q heads; returns
    (dq, dk, dv) in the inputs' dtypes. The mask is the forward's, top-left
    aligned when Sq != Sk (``_live``), so a key that no row sees gets zero
    dK and dV. A row that sees no key (a window that ends before the keys
    do, past Sk) gets the mean of v from the forward (the softmax of the
    mask value is uniform) but gives no gradient here: its P is 0. The JAX
    oracle's ``-inf`` mask gives NaN there, so the tests choose shapes
    without such rows, as every model's are."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qf, dof = q.to(torch.float32), do.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(g, dim=1)
    vf = v.to(torch.float32).repeat_interleave(g, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    ok = _live(Sq, Sk, causal, window, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    d = (dof * o.to(torch.float32)).sum(-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - d)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.reshape(B, KV, g, Sk, hd).sum(2)
    dv = dv.reshape(B, KV, g, Sk, v.shape[-1]).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q, k, v, pos, *, window=0, scale=None, kv_start=0,
                         return_lse=False):
    """q (B,KV,g,hd), k/v (B,KV,S,hd), ``pos`` an int or a 0-d integer tensor
    (on any device) -> (B,KV,g,hd) in q's dtype. Cache rows ``<= pos`` are
    live; ``window > 0`` also needs ``kpos > pos - window``. The rows may be
    a slice of a longer cache: row r is position ``kv_start + r``. With
    ``return_lse``: ``(out, lse)``, the slice's normalized partial in f32
    (0 where no row is live) and each head's log-sum-exp (B,KV,g) of its
    live scaled scores in f32 (-inf where none is live)."""
    hd = q.shape[-1]
    S = k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    kpos = kv_start + torch.arange(S, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    ok = kpos <= pos
    if window > 0:
        ok &= kpos > pos - window
    out = _softmax_av(s, ok, v)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.logsumexp(s.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.where(ok.any(-1), out, torch.zeros((), device=q.device)), lse


def combine_partials(outs, lses):
    """Merge the normalized partials ``outs`` (R, ..., dv) of R slices of
    one cache, with their log-sum-exps ``lses`` (R, ...), into the whole
    cache's attention, f32: each slice weighted by ``exp(lse_r - max_r
    lse)`` (a slice with no live row, lse -inf, weighs 0; where no slice has
    one the result is 0)."""
    outs = torch.as_tensor(outs).to(torch.float32)
    lses = torch.as_tensor(lses).to(torch.float32)
    top = lses.max(0).values
    top = torch.where(torch.isfinite(top), top, torch.zeros((), device=top.device))
    w = torch.exp(lses - top)
    den = w.sum(0)
    num = (w[..., None] * outs).sum(0)
    return num / torch.where(den > 0, den, torch.ones((), device=den.device))[..., None]


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


def ssd_scan_bwd_ref(x, dtA, Bm, Cm, dy, *, chunk=128):
    """The gradient of ``ssd_scan_ref``'s y (with respect to x, dtA, Bm and
    Cm, the final state taking none) for ``dy`` (B,H,L,P), written as the
    backward kernel's passes (``csrc/ssd_scan_bwd.cu``) in f32. Per chunk c of
    Q steps, with Acs the inclusive cumsum of dtA, Λ = Acs_{Q-1}, e = exp(Acs),
    e' = exp(Λ - Acs), the mask L and G = C Bᵀ as in the forward:

    1. the states s_c at each chunk's start, from zero, as the forward;
    2. their gradients, walking the chunks from last to first from g_nc = 0:
       g_c = g_{c+1}·exp(Λ_c) + (dy ⊙ e)ᵀ C;
    3. each chunk's gradients from dy, s_c and g_{c+1}, with dS = dy xᵀ::

           dx   = ((G ⊙ L)ᵀ dy) + e' ⊙ (B g_{c+1}ᵀ)
           dC_h = ((dS ⊙ L) B) + e ⊙ (dy s_c)
           dB_h = ((dS ⊙ L)ᵀ C) + e' ⊙ (x g_{c+1})
           dAcs = rowsum(M) - colsum(M) + rowsum(dy ⊙ e ⊙ (C s_cᵀ)) - w,
                  M = dS ⊙ L ⊙ G,  w = rowsum(x ⊙ e' ⊙ (B g_{c+1}ᵀ))
           dAcs_{Q-1} += Σ w + exp(Λ)·Σ(g_{c+1} ⊙ s_c)    (the terms through Λ)

       and d(dtA) the reverse cumsum of dAcs within the chunk;
    4. dB and dC summed over the heads (B and C are shared by all of them).

    The mask is applied before the exp, so the upper triangle's gradient is
    exactly zero. Returns (dx, d(dtA), dB, dC) in the dtypes of x, dtA, Bm and
    Cm."""
    B, H, L, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError(f"ssd_scan: L={L} is not a multiple of chunk={chunk}")
    nc, Q = L // chunk, chunk
    xf = x.float().reshape(B, H, nc, Q, P)
    dyf = dy.float().reshape(B, H, nc, Q, P)
    acs = torch.cumsum(dtA.float().reshape(B, H, nc, Q), dim=-1)
    Bf = Bm.float().reshape(B, nc, Q, N)
    Cf = Cm.float().reshape(B, nc, Q, N)
    last = acs[..., -1]  # Λ of each chunk, (B,H,nc)
    e = torch.exp(acs)
    e_end = torch.exp(last[..., None] - acs)

    # 1. the states at each chunk's start
    own = torch.einsum("bhcjp,bhcj,bcjn->bhcpn", xf, e_end, Bf)
    state = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * torch.exp(last[:, :, c])[..., None, None] + own[:, :, c]
    s = torch.stack(starts, dim=2)  # (B,H,nc,P,N)

    # 2. their gradients, from the last chunk back; g[:, :, c] is g_{c+1}
    inject = torch.einsum("bhcip,bhci,bcin->bhcpn", dyf, e, Cf)
    grad = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    ends = [None] * nc
    for c in reversed(range(nc)):
        ends[c] = grad
        grad = grad * torch.exp(last[:, :, c])[..., None, None] + inject[:, :, c]
    g = torch.stack(ends, dim=2)

    # 3. each chunk's gradients
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    Lm = torch.exp((acs[..., :, None] - acs[..., None, :]).masked_fill(~tri, -1e9))
    G = torch.einsum("bcin,bcjn->bcij", Cf, Bf)[:, None]  # (B,1,nc,Q,Q)
    D = torch.einsum("bhcip,bhcjp->bhcij", dyf, xf) * Lm
    x_off = e_end[..., None] * torch.einsum("bcjn,bhcpn->bhcjp", Bf, g)
    dx = torch.einsum("bhcij,bhcip->bhcjp", G * Lm, dyf) + x_off
    dC = torch.einsum("bhcij,bcjn->bhcin", D, Bf) \
        + e[..., None] * torch.einsum("bhcip,bhcpn->bhcin", dyf, s)
    dB = torch.einsum("bhcij,bcin->bhcjn", D, Cf) \
        + e_end[..., None] * torch.einsum("bhcjp,bhcpn->bhcjn", xf, g)
    M = D * G
    y_off = e[..., None] * torch.einsum("bcin,bhcpn->bhcip", Cf, s)
    w = (xf * x_off).sum(-1)
    dacs = M.sum(-1) - M.sum(-2) + (dyf * y_off).sum(-1) - w
    dlast = w.sum(-1) + torch.exp(last) * (g * s).sum((-1, -2))
    dacs = torch.cat([dacs[..., :-1], (dacs[..., -1] + dlast)[..., None]], dim=-1)
    ddtA = torch.flip(torch.cumsum(torch.flip(dacs, [-1]), dim=-1), [-1])

    # 4. B and C are shared by the heads
    return (dx.reshape(B, H, L, P).to(x.dtype), ddtA.reshape(B, H, L).to(dtA.dtype),
            dB.sum(1).reshape(B, L, N).to(Bm.dtype), dC.sum(1).reshape(B, L, N).to(Cm.dtype))
