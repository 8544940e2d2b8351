"""The decode attention over one slice of a longer cache (``kv_start``) with
its log-sum-exp, and ``combine_partials``, which merges the slices'
partials: the split-S decode that context-parallel serving carries across
ranks.

On the CPU ``ops.decode_attention`` runs its plain version
(``kernels/ref.py:decode_attention_ref``). The slices of a cache, each
attended at its global positions and then combined, are held against the
whole-cache plain version and against the JAX package's decode attention:
its Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs it)
where q·k and v are one width, its oracle at MLA's (576, 512). Tolerances
are ``tests/test_kernels.py:19``'s: f32 2e-5, bf16 2e-2. A numpy emulation
of the CUDA kernel's per-CTA row ranges under ``kv_start`` (its
``live_range`` and ``decode_attention.geometry``'s splits) shows every live
row read by exactly one CTA of one slice and a dead CTA or slice reading
none, at the test shapes and at ``long_500k``'s 524,288 rows in 4 and 256
slices; a float64 emulation of its per-warp partials, fold and LSE formula
gives the plain version's result. The card runs the kernel itself
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3b).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:19
MLA_SCALE = 192 ** -0.5

# (B, KV, g, S, dk, dv, pos, window, slices)
CASES = [
    (2, 2, 4, 384, 128, 128, 383, 0, 4),    # pos in the last slice, every row live
    (2, 2, 4, 384, 128, 128, 50, 0, 4),     # pos in the first slice: three dead slices
    (1, 2, 2, 384, 128, 128, 200, 64, 4),   # the window crosses the boundary at 192
    (1, 2, 8, 384, 128, 128, 300, 16, 3),   # a window inside one slice of 128
    (2, 2, 2, 256, 256, 256, 255, 0, 4),    # gemma3's width, global
    (1, 2, 2, 256, 256, 256, 130, 64, 4),   # and local, across the boundary at 128
    (2, 1, 16, 256, 576, 512, 255, 0, 4),   # MLA's absorbed decode: V is K's rows
    (2, 1, 16, 256, 576, 512, 70, 0, 4),
]
IDS = ["x".join(map(str, c[:6])) + f"-pos{c[6]}-w{c[7]}-r{c[8]}" for c in CASES]


def _inputs(case, dtype, seed=0):
    B, KV, g, S, dk, dv, pos, window, R = case
    rng = np.random.default_rng(seed + S + pos + window)
    a = {name: rng.standard_normal(shape).astype(np.float32)
         for name, shape in (("q", (B, KV * g, dk)), ("k", (B, KV, S, dk)),
                             ("v", (B, KV, S, dv)))}
    td = DTYPES[dtype][1]
    q, k = torch.from_numpy(a["q"]).to(td), torch.from_numpy(a["k"]).to(td)
    v = k[..., :dv] if dv != dk else torch.from_numpy(a["v"]).to(td)
    return q, k, v, (MLA_SCALE if dv != dk else None)


def _cut(k, v, lo, hi):
    """Rows [lo, hi) of the caches as a rank stores them (its own tensors;
    V as a view of K's rows where it is K's leading columns)."""
    ks = k[:, :, lo:hi].contiguous()
    shared = v.data_ptr() == k.data_ptr() and v.shape[-1] != k.shape[-1]
    return ks, (ks[..., :v.shape[-1]] if shared else v[:, :, lo:hi].contiguous())


def _slices(q, k, v, pos, window, R, scale):
    """Each slice's (partial, lse), attended at its global positions."""
    S = k.shape[2]
    n = S // R
    return [tops.decode_attention(q, *_cut(k, v, r * n, (r + 1) * n), pos, window=window,
                                  scale=scale, kv_start=r * n, return_lse=True)
            for r in range(R)]


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slices_combined_are_the_whole_cache(case, dtype):
    """R slices, each attended at its global positions and merged by
    ``combine_partials``, against the whole-cache plain version and the JAX
    package's decode attention (its Pallas kernel in interpret mode; its
    oracle at (576, 512), whose q·k and v widths differ)."""
    B, KV, g, S, dk, dv, pos, window, R = case
    q, k, v, scale = _inputs(case, dtype)
    parts = _slices(q, k, v, pos, window, R, scale)
    for out, lse in parts:
        assert out.dtype == torch.float32 and lse.dtype == torch.float32
        assert out.shape == (B, KV * g, dv) and lse.shape == (B, KV * g)
    merged = tref.combine_partials(torch.stack([o for o, _ in parts]),
                                   torch.stack([l for _, l in parts])).to(q.dtype)
    whole = tops.decode_attention(q, k, v, pos, window=window, scale=scale)
    _close(merged.float(), whole.float(), dtype)
    jd = DTYPES[dtype][0]
    jq, jk = jnp.asarray(q.float().numpy(), jd), jnp.asarray(k.float().numpy(), jd)
    if dv == dk:
        jv = jnp.asarray(v.float().numpy(), jd)
        want = jops.decode_attention(jq, jk, jv, pos, window=window)
    else:
        want = jref.decode_attention_ref(jq.reshape(B, KV, g, dk), jk, jk[..., :dv], pos,
                                         window=window, scale=scale).reshape(B, KV * g, dv)
    _close(merged.float(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_is_the_slices_log_sum_exp(dtype):
    """The LSE is the log-sum-exp of the slice's live scaled scores, and the
    partial is the slice's softmax over those rows alone."""
    case = (2, 2, 4, 256, 128, 128, 200, 100, 2)
    q, k, v, _ = _inputs(case, dtype)
    pos, window, n = 200, 100, 128
    out, lse = tops.decode_attention(q, *_cut(k, v, n, 2 * n), pos, window=window,
                                     kv_start=n, return_lse=True)
    s = torch.einsum("bkgd,bksd->bkgs", q.float().view(2, 2, 4, 128), k[:, :, n:].float())
    s = s * 128 ** -0.5
    live = (torch.arange(n, 2 * n) <= pos) & (torch.arange(n, 2 * n) > pos - window)
    want_lse = torch.logsumexp(s[..., live], -1).reshape(2, 8)
    want = torch.einsum("bkgs,bksd->bkgd", torch.softmax(s[..., live], -1),
                        v[:, :, n:][:, :, live].float()).reshape(2, 8, 128)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_a_dead_slice_weighs_nothing():
    """A slice with no live row (past pos, or before the window) gives 0 and
    -inf; the combine leaves it out, and where no slice has a live row the
    combine gives 0."""
    case = (1, 2, 2, 256, 128, 128, 100, 32, 2)
    q, k, v, _ = _inputs(case, "float32")
    for kv_start in (128, 0):  # past pos; and a window of 32 ending at 300, after it
        pos = 100 if kv_start == 128 else 300
        out, lse = tops.decode_attention(q, *_cut(k, v, 0, 128), pos, window=32,
                                         kv_start=kv_start, return_lse=True)
        assert torch.equal(out, torch.zeros_like(out))
        assert torch.isneginf(lse).all()
    live = tops.decode_attention(q, *_cut(k, v, 0, 128), 100, window=32, return_lse=True)
    dead = (torch.zeros_like(live[0]), torch.full_like(live[1], float("-inf")))
    merged = tref.combine_partials(torch.stack([live[0], dead[0]]),
                                   torch.stack([live[1], dead[1]]))
    assert torch.equal(merged, live[0])
    none = tref.combine_partials(torch.stack([dead[0], dead[0]]), torch.stack([dead[1], dead[1]]))
    assert torch.equal(none, torch.zeros_like(none))


def test_the_whole_cache_call_is_unchanged():
    """``kv_start = 0`` without the LSE is the whole-cache call, in q's dtype;
    with the LSE its partial, rounded to q's dtype, is that call's output."""
    case = (2, 2, 4, 256, 128, 128, 180, 0, 1)
    q, k, v, _ = _inputs(case, "bfloat16")
    whole = tops.decode_attention(q, k, v, 180)
    assert whole.dtype == torch.bfloat16
    assert torch.equal(tops.decode_attention(q, k, v, 180, kv_start=0), whole)
    out, _ = tops.decode_attention(q, k, v, 180, return_lse=True)
    assert torch.equal(out.to(torch.bfloat16), whole)


def test_a_negative_kv_start_raises():
    q, k, v, _ = _inputs((1, 1, 2, 64, 128, 128, 10, 0, 1), "float32")
    with pytest.raises(Exception, match="kv_start"):
        tops.decode_attention(q, k, v, 10, kv_start=-1)


# ------------------------------------------------ the kernel's row ranges
def _live_range(pos, S, window, kv_start):
    """``csrc/decode_attention.cu:live_range``: the slice's live rows [lo, hi]."""
    first = pos - window + 1 if (window > 0 and pos - window + 1 > 0) else 0
    lo = first - kv_start if first > kv_start else 0
    hi = pos - kv_start if pos - kv_start < S - 1 else S - 1
    return lo, hi


def test_the_emulated_live_range_is_the_sources():
    """The emulation's arithmetic is the source's ``live_range``."""
    text = (Path(_build.CSRC) / "decode_attention.cu").read_text()
    body = re.search(r"void live_range\((.*?)\n}", text, re.S).group(1)
    for line in ("first = (window > 0 && pos - window + 1 > 0) ? pos - window + 1 : 0",
                 "*lo = first > kv_start ? first - kv_start : 0",
                 "*hi = pos - kv_start < S - 1 ? pos - kv_start : S - 1"):
        assert line in body, line
    for use in ("const int s0 = max(lo, rank * chunk);",
                "const int s1 = min(hi + 1, (rank + 1) * chunk);"):
        assert use in text, use


def _cta_rows(S_total, R, pos, window, B=1, KV=8, g=2, dk=256, sms=132):
    """{(slice, cta): (first global row, rows)} of every CTA that reads,
    and the number of CTAs that read nothing, as the kernel splits each
    slice (``geometry``) and cuts each split to the live range."""
    n = S_total // R
    cluster, chunk = tda.geometry(B, KV, g, n, sms, dk)
    reads, idle = {}, 0
    for r in range(R):
        lo, hi = _live_range(pos, n, window, r * n)
        for c in range(cluster):
            s0, s1 = max(lo, c * chunk), min(hi + 1, (c + 1) * chunk)
            if s1 > s0:
                reads[(r, c)] = (r * n + s0, s1 - s0)
            else:
                idle += 1
    return reads, idle


@pytest.mark.parametrize("S_total,R,pos,window", [
    (384, 4, 383, 0), (384, 4, 50, 0), (384, 4, 200, 64), (256, 4, 130, 64),
    (524288, 1, 524287, 0), (524288, 4, 524287, 0), (524288, 256, 524287, 0),
    (524288, 4, 524287, 1024), (524288, 256, 524287, 1024), (524288, 256, 524279, 1024),
    (524288, 256, 131071, 0),
])
def test_every_live_row_is_read_once(S_total, R, pos, window):
    """Over every slice and CTA, the rows read are exactly the live ones,
    each once; so a slice past pos or before the window copies no byte (at
    ``long_500k``'s 524,288 rows over 256 slices and window 1,024, all but
    the last one or two slices read nothing)."""
    reads, idle = _cta_rows(S_total, R, pos, window)
    rows = np.zeros(S_total, np.int64)
    for start, count in reads.values():
        rows[start:start + count] += 1
    kpos = np.arange(S_total)
    live = (kpos <= pos) & ((kpos > pos - window) if window else True)
    assert np.array_equal(rows, live.astype(np.int64))
    slices_read = {r for r, _ in reads}
    n = S_total // R
    want = {r for r in range(R) if live[r * n:(r + 1) * n].any()}
    assert slices_read == want
    if window == 1024 and R == 256:
        assert len(slices_read) <= 2 and idle >= (R - 2) * tda.geometry(1, 8, 2, n, 132, 256)[0]


def _emulate(q, k, v, pos, window, kv_start, scale, cluster, chunk, tile=64, warps=8):
    """The kernel's arithmetic in float64 for one (b, kv head): each warp's
    (m, l, acc) in log2 units over its keys of each tile of each CTA's live
    rows, the fold over the cluster's warps, the LSE as (M + log2 L)·ln 2."""
    g, S = q.shape[0], k.shape[0]
    ql = q * scale * math.log2(math.e)
    lo, hi = _live_range(pos, S, window, kv_start)
    parts = []
    for c in range(cluster):
        s0, s1 = max(lo, c * chunk), min(hi + 1, (c + 1) * chunk)
        for w in range(warps):
            m, l, acc = np.full(g, -1e30), np.zeros(g), np.zeros((g, v.shape[1]))
            for t0 in range(s0, s1, tile):
                keys = [t0 + w * (tile // warps) + j for j in range(tile // warps)]
                keys = [key for key in keys if key < min(s1, t0 + tile)]
                if not keys:
                    continue
                sc = ql @ k[keys].T  # (g, keys)
                m_new = np.maximum(m, sc.max(1))
                alpha = np.exp2(m - m_new)
                p = np.exp2(sc - m_new[:, None])
                l, acc, m = l * alpha + p.sum(1), acc * alpha[:, None] + p @ v[keys], m_new
            parts.append((m, l, acc))
    live = [(m, l, a) for m, l, a in parts if (l > 0).all()]
    if not live:
        return np.zeros((g, v.shape[1])), np.full(g, -np.inf)
    M = np.max([m for m, _, _ in live], 0)
    L = sum(l * np.exp2(m - M) for m, l, _ in live)
    A = sum(a * np.exp2(m - M)[:, None] for m, _, a in live)
    return A / L[:, None], (M + np.log2(L)) * math.log(2)


@pytest.mark.parametrize("case", CASES[:6], ids=IDS[:6])
def test_emulated_kernel_gives_the_plain_slices(case):
    """The float64 emulation of the kernel's walk, fold and LSE formula on
    each slice, at the split ``geometry`` gives, equals the plain version's
    partial and LSE."""
    B, KV, g, S, dk, dv, pos, window, R = case
    q, k, v, scale = _inputs(case, "float32")
    n = S // R
    cluster, chunk = tda.geometry(B, KV, g, n, 132, dk)
    for r in range(R):
        out, lse = tops.decode_attention(q, *_cut(k, v, r * n, (r + 1) * n), pos,
                                         window=window, kv_start=r * n, return_lse=True)
        for b in range(B):
            for h in range(KV):
                qq = q[b, h * g:(h + 1) * g].double().numpy()
                kk = k[b, h, r * n:(r + 1) * n].double().numpy()
                vv = v[b, h, r * n:(r + 1) * n].double().numpy()
                o, l = _emulate(qq, kk, vv, pos, window, r * n, dk ** -0.5, cluster, chunk)
                np.testing.assert_allclose(out[b, h * g:(h + 1) * g].numpy(), o, rtol=1e-5,
                                           atol=1e-6)
                np.testing.assert_allclose(lse[b, h * g:(h + 1) * g].numpy(), l, rtol=1e-6,
                                           atol=1e-5)
