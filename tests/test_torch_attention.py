"""The port's attention ops and their plain versions against the JAX package.

Inputs come from numpy seeds and go to both packages. On the CPU the port's
``ops.flash_attention`` / ``ops.decode_attention`` run their plain PyTorch
versions (``repro_torch.kernels.ref``); they are held against the JAX
package's Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs
them) and its pure-jnp oracles, over the sweep of ``tests/test_kernels.py``,
with its tolerances: f32 ``2e-5``, bf16 ``2e-2``. The CUDA kernels are held
against the same plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

The attention's gradient (the port trains through ``ops.flash_attention``,
whose backward is a kernel on the card) is held to ``jax.grad`` of the JAX
package's oracle ``repro.kernels.ref.flash_attention_ref``, relative to each
gradient's largest entry: f32 ``1e-4`` (the FlashAttention-2 formulas
against autodiff through a softmax, f32 sums in another order), bf16 ``2e-2``
(the forward's bf16 tolerance; dq, dk, dv are rounded to bf16 once).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.core.spec import RawArrayError
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:19
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of each gradient's max |entry|


def _pair(rng, shape, dtype):
    """The same values as a jax array and a torch tensor (bf16 rounds the
    same f32 values to nearest even on both sides)."""
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 2, 2, 128, 64),
    (2, 4, 2, 256, 64),
    (1, 8, 2, 384, 128),
    (2, 2, 1, 128, 128),
    (1, 4, 2, 128, 256),   # gemma3's head width
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_attention_matches_jax(B, H, KV, S, hd, dtype, causal, window):
    rng = np.random.default_rng(B * 1000 + H * 100 + S + hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, sh, dtype) for sh in
                                    ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
    jax_kernel = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    jax_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    port_op = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    port_ref = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert port_op.dtype == tq.dtype and port_op.shape == tq.shape
    assert torch.equal(port_op, port_ref)  # the CPU path is the plain version
    _close(port_op, jax_kernel, dtype)
    _close(port_ref, jax_ref, dtype)


@pytest.mark.parametrize("B,KV,g,S,hd,pos,window", [
    (1, 2, 4, 256, 64, 100, 0),
    (2, 1, 8, 512, 128, 511, 0),
    (2, 4, 1, 128, 64, 0, 0),
    (1, 2, 2, 256, 64, 200, 64),
    (2, 2, 2, 256, 256, 255, 0),   # gemma3's head width and group, global
    (1, 2, 2, 256, 256, 200, 64),  # and local (windowed)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(B, KV, g, S, hd, pos, window, dtype):
    rng = np.random.default_rng(B * 1000 + KV * 100 + S + pos)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, sh, dtype) for sh in
                                    ((B, KV * g, hd), (B, KV, S, hd), (B, KV, S, hd)))
    jax_kernel = jops.decode_attention(jq, jk, jv, pos, window=window)
    jax_ref = jref.decode_attention_ref(jq.reshape(B, KV, g, hd), jk, jv, pos, window=window)
    port_op = tops.decode_attention(tq, tk, tv, pos, window=window)
    port_ref = tref.decode_attention_ref(tq.reshape(B, KV, g, hd), tk, tv, pos, window=window)
    assert port_op.dtype == tq.dtype and port_op.shape == tq.shape
    _close(port_op, jax_kernel, dtype)
    _close(port_ref, jax_ref, dtype)


def _dispatched_head_dims(source: str) -> list:
    """The ``case N:`` labels of each ``switch (hd)`` in a CUDA source."""
    text = (Path(_build.CSRC) / source).read_text()
    return [tuple(int(c) for c in re.findall(r"case (\d+):", body))
            for body in re.findall(r"switch \(hd\) \{(.*?)\n\s*\}", text, re.S)]


def test_cuda_dispatch_instantiates_every_head_dim():
    """Each kernel's head-width dispatch instantiates exactly ``HEAD_DIMS``,
    which ``check_inputs`` lets through: the f32 and bf16 prefill kernels
    and the decode kernel."""
    assert _dispatched_head_dims("flash_attention.cu") == [tfa.HEAD_DIMS] * 2
    assert _dispatched_head_dims("decode_attention.cu") == [tfa.HEAD_DIMS]
    assert get_config("gemma3_12b").head_dim in tfa.HEAD_DIMS  # 256


def test_decode_attention_masks_beyond_pos():
    """Cache rows beyond pos are dead, whatever they hold (tests/test_kernels.py:55-64)."""
    B, KV, g, S, hd = 1, 1, 2, 128, 64
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, sh, "float32") for sh in
                                    ((B, KV * g, hd), (B, KV, S, hd), (B, KV, S, hd)))
    out1 = tops.decode_attention(tq, tk, tv, 10)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, :, 11:] = 999.0
    tv2[:, :, 11:] = -999.0
    out2 = tops.decode_attention(tq, tk2, tv2, 10)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)
    _close(out2, jops.decode_attention(jq, jk.at[:, :, 11:].set(999.0),
                                       jv.at[:, :, 11:].set(-999.0), 10), "float32")


def test_decode_attention_takes_pos_as_a_tensor():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 64, 32)).astype(np.float32))
            for _ in range(2))
    by_int = tops.decode_attention(q, k, v, 37, window=16)
    for pos in (torch.tensor(37, dtype=torch.int32), torch.tensor([37], dtype=torch.int32)):
        assert torch.equal(tops.decode_attention(q, k, v, pos, window=16), by_int)


def test_attention_ops_are_forward_only():
    """``decode_attention`` (and ``ssd_scan``, tests/test_torch_ssd.py) have no
    backward and raise under grad; ``flash_attention`` under grad returns
    gradients, through its ``autograd.Function``."""
    q = torch.randn(1, 2, 8, 32, requires_grad=True)
    q1 = torch.randn(1, 2, 32, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 32), torch.randn(1, 2, 8, 32)
    with pytest.raises(RawArrayError, match="forward-only"):
        tops.decode_attention(q1, k, v, 3)
    with pytest.raises(RawArrayError, match="forward-only"):
        tfa.flash_attention_fwd(q, k, v)  # the bare kernel call records no gradient
    out = tops.flash_attention(q, k, v)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (dq,) = torch.autograd.grad(out.sum(), q)
    assert dq.shape == q.shape and torch.isfinite(dq).all()
    with torch.no_grad():
        assert tops.flash_attention(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert tops.decode_attention(q1, k, v, 3).shape == (1, 2, 32)


def _grads_close(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == DTYPES[dtype][1], name
        tol = GRAD_TOL[dtype] * float(np.abs(w).max())
        np.testing.assert_allclose(g.float().numpy(), w, rtol=GRAD_TOL[dtype], atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 2, 2, 64, 32),     # groups of 1
    (2, 4, 2, 100, 64),    # groups of 2, a ragged S
    (1, 8, 1, 70, 128),    # groups of 8 (all q heads on one KV head)
    (2, 16, 8, 33, 128),   # InternLM2's heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_flash_attention_grad_matches_jax(B, H, KV, S, hd, dtype, causal, window):
    """dq, dk, dv of ``ops.flash_attention`` (on the CPU: the plain forward,
    with its log-sum-exp, and ``ref.flash_attention_bwd_ref``) against
    ``jax.grad`` of the JAX oracle, for a random output gradient."""
    rng = np.random.default_rng(B * 100 + H * 10 + S + hd)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng, sh, dtype) for sh in
        ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd)))

    def jloss(q, k, v):
        out = jref.flash_attention_ref(q, k, v, causal=causal, window=window)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out = tops.flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), tdo)
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window", [
    (2, 4, 2, 37, 32, True, 0),
    (1, 8, 2, 64, 64, True, 16),
    (2, 2, 2, 20, 32, False, 0),
    (1, 4, 1, 33, 128, False, 8),
])
def test_flash_attention_bwd_ref_matches_autograd(B, H, KV, S, hd, causal, window):
    """The FlashAttention-2 formulas of ``ref.flash_attention_bwd_ref`` (the
    CPU path's backward and the kernel's plain version) against PyTorch's
    own autograd through ``ref.flash_attention_ref``, in f32."""
    gen = torch.Generator().manual_seed(S + hd)
    q = torch.randn(B, H, S, hd, generator=gen, requires_grad=True)
    k, v = (torch.randn(B, KV, S, hd, generator=gen, requires_grad=True) for _ in range(2))
    do = torch.randn(B, H, S, hd, generator=gen)
    out = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(out, (q, k, v), do)
    with torch.no_grad():
        o, lse = tref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                          return_lse=True)
        got = tref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    assert torch.equal(o, out.detach())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))


def test_flash_attention_backward_checks_its_inputs():
    q = torch.randn(1, 2, 8, 32)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(RawArrayError, match="Sq = Sk"):
        tfa.flash_attention_bwd(q, torch.randn(1, 2, 9, 32), torch.randn(1, 2, 9, 32), q, q, lse)
    with pytest.raises(RawArrayError, match="lse must be"):
        tfa.flash_attention_bwd(q, q, q, q, q, lse.double())
    with pytest.raises(RawArrayError, match="q's shape"):
        tfa.flash_attention_bwd(q, q, q, q[:, :, :4], q, lse)


def test_flash_attention_under_grad_checks_the_backward_first():
    """A case the backward cannot take (Sq != Sk) raises under grad before
    the forward runs; without grad the same call is a forward."""
    q = torch.randn(1, 2, 8, 32, requires_grad=True)
    kv = torch.randn(1, 2, 9, 32)
    with pytest.raises(RawArrayError, match="Sq = Sk"):
        tops.flash_attention(q, kv, kv)
    with torch.no_grad():
        assert tops.flash_attention(q, kv, kv).shape == q.shape


def test_backward_dispatch_instantiates_its_head_dims():
    """The backward kernels' head-width dispatch instantiates exactly
    ``BWD_HEAD_DIMS`` of its dtype: the f32 SIMT pair, then the bf16
    tensor-core pair, which takes gemma3's 256 (the wrapper raises for any
    other width)."""
    assert _dispatched_head_dims("flash_attention_bwd.cu") == [
        tfa.BWD_HEAD_DIMS[torch.float32], tfa.BWD_HEAD_DIMS[torch.bfloat16]]
    assert get_config("gemma3_12b").head_dim in tfa.BWD_HEAD_DIMS[torch.bfloat16]
    assert "flash_attention_bwd.cu" in _build.SOURCES


def test_build_hashes_the_shared_header(tmp_path, monkeypatch):
    """Both attention libraries include ``csrc/sm90.cuh``, so its bytes are
    part of each library's name: an edited header cannot load a stale
    library (checked on a copy of ``csrc/``)."""
    for source in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert '#include "sm90.cuh"' in (Path(_build.CSRC) / source).read_text()
    for f in Path(_build.CSRC).iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.lib_path("flash_attention_bwd.cu")
    (tmp_path / "sm90.cuh").write_bytes((tmp_path / "sm90.cuh").read_bytes() + b"\n")
    assert _build.lib_path("flash_attention_bwd.cu") != before


def _bwd_schedule(S: int, H: int, KV: int, hd: int, *, causal: bool, window: int) -> dict:
    """A numpy-side emulation of the bf16 backward kernels' walk for one
    batch entry, with the kernels' own integer arithmetic (``dq_kernel`` and
    ``dkdv_kernel`` of ``csrc/flash_attention_bwd.cu``) over the tiles of
    ``bwd_geometry``, the plan the launch passes to the kernels (which refuse
    tiles not their own). ``"dq"``: for each dQ CTA in launch order (the
    linear CTA index; the last q tiles first) ``(q0, h, [k0 of each K/V tile
    visited, in order])``; ``"dkdv"``: for each dK/dV CTA in launch order
    (the first K/V tiles first) ``(k0, kvh, [(h, q0) visited, in order])``.
    Inside a visited pair of tiles the kernels mask to the live pairs, so
    every live (q row, key) pair of a q head must lie in exactly one visited
    pair of tiles of each kernel."""
    (bq, bk), (kb, qb), _ = tfa.bwd_geometry(S, hd)
    group = H // KV
    dq = []
    n_qt = -(-S // bq)
    for lin in range(n_qt * H):
        q0, h = (n_qt - 1 - lin // H) * bq, lin % H
        q_rows = min(bq, S - q0)
        n_tiles = -(-S // bk)
        t_hi = min(n_tiles, (q0 + q_rows - 1) // bk + 1) if causal else n_tiles
        t_lo = (q0 - window + 1) // bk if window > 0 and q0 - window + 1 > 0 else 0
        dq.append((q0, h, [t * bk for t in range(t_lo, max(t_lo, t_hi))]))
    dkdv = []
    n_kt, n_q = -(-S // kb), -(-S // qb)
    for lin in range(n_kt * KV):
        k0, kvh = (lin // KV) * kb, lin % KV
        k_rows = min(kb, S - k0)
        u_lo = k0 // qb if causal else 0
        u_hi = min(n_q, (k0 + k_rows - 1 + window - 1) // qb + 1) if window > 0 else n_q
        per_head = max(0, u_hi - u_lo)
        dkdv.append((k0, kvh, [(kvh * group + i // per_head, (u_lo + i % per_head) * qb)
                               for i in range(group * per_head)]))
    return {"dq": dq, "dkdv": dkdv}


def _live(S: int, causal: bool, window: int) -> np.ndarray:
    q, k = np.arange(S)[:, None], np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= k <= q
    if window > 0:
        ok &= k > q - window
    return ok


@pytest.mark.parametrize("S,H,KV,hd,causal,window", [
    (300, 4, 4, 128, True, 0),     # groups of 1, a ragged S
    (300, 8, 4, 64, True, 64),     # groups of 2, a window inside a tile
    (200, 8, 1, 32, True, 0),      # groups of 8
    (1100, 4, 2, 256, True, 1024),  # gemma3's width and window, across many tiles
    (256, 16, 8, 256, True, 0),    # gemma3's heads, global
    (192, 4, 2, 128, True, 0),     # a multiple of the 64-row tiles, not of 128
    (130, 2, 2, 128, False, 0),    # non-causal
    (1, 2, 1, 64, True, 0),        # one row
])
def test_bwd_schedule_visits_every_live_pair_once(S, H, KV, hd, causal, window):
    """The bf16 backward's walk, emulated (``_bwd_schedule``): each kernel's
    CTAs cover each (q tile, q head) or (K/V tile, KV head) once, the
    heaviest causal tiles first; every live (q row, key) pair of every q head
    lies in exactly one visited pair of tiles of each kernel, and no pair of
    tiles is visited twice; a dK/dV CTA walks its group's q heads in order,
    and each head's q tiles in order. The LSE/D scratch's rows a head
    (``S_pad``) hold every ring tile the dK/dV kernel copies, and the dQ
    kernel's CTAs, whose warpgroups of 64 rows with a live row write them,
    reach the last one."""
    sched = _bwd_schedule(S, H, KV, hd, causal=causal, window=window)
    (bq, bk), (kb, qb), S_pad = tfa.bwd_geometry(S, hd)
    live = _live(S, causal, window)
    group = H // KV

    ctas = [(q0, h) for q0, h, _ in sched["dq"]]
    assert sorted(ctas) == [(q0, h) for q0 in range(0, S, bq) for h in range(H)]
    assert [q0 for q0, _ in ctas] == sorted((q0 for q0, _ in ctas), reverse=True)
    cover = np.zeros((H, S, S), np.int32)
    for q0, h, keys in sched["dq"]:
        assert keys == sorted(keys)
        for k0 in keys:
            cover[h, q0:q0 + bq, k0:k0 + bk] += 1
    assert (cover[:, live] == 1).all() and cover.max() <= 1

    ctas = [(k0, kvh) for k0, kvh, _ in sched["dkdv"]]
    assert sorted(ctas) == [(k0, kvh) for k0 in range(0, S, kb) for kvh in range(KV)]
    assert [k0 for k0, _ in ctas] == sorted(k0 for k0, _ in ctas)
    cover[:] = 0
    for k0, kvh, walk in sched["dkdv"]:
        assert walk == sorted(walk)
        assert {h for h, _ in walk} == set(range(kvh * group, (kvh + 1) * group))
        for h, q0 in walk:
            cover[h, q0:q0 + qb, k0:k0 + kb] += 1
            assert q0 + qb <= S_pad
    assert (cover[:, live] == 1).all() and cover.max() <= 1
    assert S_pad % qb == 0 and S_pad >= S
    assert max(q0 + -(-min(bq, S - q0) // 64) * 64 for q0, _, _ in sched["dq"]) >= S_pad


def test_attention_ops_check_their_inputs():
    q, k = torch.randn(1, 2, 8, 32), torch.randn(1, 2, 8, 32)
    with pytest.raises(RawArrayError, match="mixed dtypes"):
        tops.flash_attention(q, k, k.double())
    with pytest.raises(RawArrayError, match="contiguous"):
        tops.flash_attention(q.transpose(2, 3), k.transpose(2, 3), k.transpose(2, 3))
    with pytest.raises(RawArrayError, match="does not fit"):
        tops.flash_attention(torch.randn(1, 3, 8, 32), k, k)


@pytest.mark.parametrize("B,KV,g,S,sms,expect", [
    (8, 8, 2, 576, 132, (2, 288)),     # the serving shape: 64 clusters of 2 CTAs
    (8, 8, 2, 4096, 132, (2, 2048)),   # S 4096
    (1, 8, 2, 576, 132, (8, 72)),      # B 1: 8 clusters of 8
    (1, 1, 1, 40, 132, (1, 40)),       # S < 64: one CTA
    (2, 1, 8, 17, 132, (1, 17)),
    (1, 1, 1, 100, 132, (2, 50)),      # room for two CTAs of at least 32 keys
    (1, 2, 5, 200, 132, (4, 50)),      # g 5 (Qwen2.5-14B's 40/8): one head a CTA
    (2, 8, 5, 4096, 132, None),
    (64, 8, 2, 576, 132, (1, 576)),    # B·KV·(g/G) fills the SMs: no split
    (1, 1, 1, 1, 132, (1, 1)),         # one key
    (3, 2, 6, 300, 132, None),
    (1, 4, 4, 129, 78, None),          # a card with fewer SMs
    (4, 8, 8, 1000, 132, None),
    (1, 1, 2, 70, 132, (2, 35)),
    (4, 8, 2, 2080, 132, (2, 1040)),   # gemma3's decode: clusters of 4 would need 128 SMs
    (2, 8, 2, 2080, 132, (4, 520)),    # 64 CTAs in clusters of 4; of 8 they would need 128
    (1, 8, 2, 2080, 132, (8, 260)),
])
def test_decode_geometry(B, KV, g, S, sms, expect):
    """Every key in exactly one CTA, an allowed cluster size that divides the
    split axis of the grid, and no CTA without a key when S >= the CTAs."""
    cluster, chunk = tda.geometry(B, KV, g, S, sms)
    if expect is not None:
        assert (cluster, chunk) == expect
    assert cluster in tda.CLUSTER_SIZES
    clusters = B * KV * (g // tda.heads_per_block(g))
    grid = (cluster, KV * (g // tda.heads_per_block(g)), B)
    assert grid[0] % cluster == 0 and grid[1] * grid[2] == clusters
    if clusters >= sms:
        assert cluster == 1
    else:
        assert clusters * cluster <= sms  # one wave of one CTA an SM
        if cluster >= 4:  # clusters of 4 or 8 reach fewer SMs
            assert clusters * cluster <= sms - tda._CLUSTER_SMS_LOST
    owners = np.zeros(S, int)
    for r in range(cluster):
        lo, hi = r * chunk, min(S, (r + 1) * chunk)
        owners[lo:hi] += 1
        if S >= cluster:
            assert hi > lo, f"CTA {r} of {cluster} has no key"
    assert (owners == 1).all()
