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
    """The backward kernels' head-width dispatch (f32 SIMT and bf16 tensor
    cores) instantiates exactly ``BWD_HEAD_DIMS`` (hd 256 raises in the
    wrapper, naming its ROADMAP item)."""
    assert _dispatched_head_dims("flash_attention_bwd.cu") == [tfa.BWD_HEAD_DIMS] * 2
    assert "flash_attention_bwd.cu" in _build.SOURCES


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
