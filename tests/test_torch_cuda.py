"""Tests of the port that need a CUDA card: each hand-written kernel against
its plain PyTorch version (the attention's backward too), the device feed
on the card against the host decode, a dense train step and a reduced
Zamba2's serving path on the card against the CPU's, and dense, Mamba2 and
Zamba2 decode steps that must not sync with the host. Each skips without a
card. This file imports nothing of JAX, so it
runs on a machine that has a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.spec import RawArrayError
from repro_torch.data import DataLoader, DatasetBuilder, DeviceLoader, RaDataset
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import dequant_u8 as dq
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("shape,out", [
    ((512, 32, 32, 3), torch.float32),
    ((1000, 130), torch.bfloat16),
    ((1, 1), torch.float16),
    ((33, 7), torch.float64),
])
def test_kernel_matches_plain_version(card, shape, out):
    """Bit-equal: both compute the f32 multiply and add as two rounded ops."""
    rng = np.random.default_rng(2)
    C = shape[-1]
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(card)
    s = torch.from_numpy(rng.random(C).astype(np.float32) * 0.02).to(card)
    b = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).to(card)
    before = dq.launches
    got = ops.dequant_rows(x, s, b, out_dtype=out)
    torch.cuda.synchronize()
    assert dq.launches == before + 1
    assert torch.equal(got, ref.dequant_u8_ref(x, s, b, out))


@pytest.mark.parametrize("C", [1, 3, 4, 7, 16, 128, 130, 4096, 4097])
@pytest.mark.parametrize("out", [torch.float32, torch.float16, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("offset", [0, 1, 8])
def test_dequant_kernel_matches_plain_version_at_every_channel_count(card, C, out, offset):
    """Bit-equal at channel counts whose period in groups is 1, a few, or C
    (large and odd), with codes at a 16-byte aligned, an odd (single-code
    groups) and an 8-byte aligned address; at n < 16 and at row counts that
    are a multiple of no thread's groups."""
    rng = np.random.default_rng(C + offset)
    s = torch.from_numpy(rng.random(C).astype(np.float32) * 0.02).to(card)
    b = torch.from_numpy(rng.standard_normal(C).astype(np.float32)).to(card)
    for shape in ((C,), (37, C), (1001, C)):
        n = int(np.prod(shape))
        buf = torch.from_numpy(rng.integers(0, 256, n + offset, dtype=np.uint8)).to(card)
        x = buf[offset:].view(shape)
        assert x.data_ptr() % 16 == offset
        before = dq.launches
        got = ops.dequant_rows(x, s, b, out_dtype=out)
        torch.cuda.synchronize()
        assert dq.launches == before + 1
        assert torch.equal(got, ref.dequant_u8_ref(x, s, b, out)), shape


def test_dequant_kernel_indexes_past_two_to_the_31(card):
    """More than 2**31 codes (C = 3, bf16 out: 6.4 GB on the card): the
    kernel's 64-bit indices reach the end, held to the plain version slice by
    slice."""
    rows = 2**31 // 3 + 5
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randint(0, 256, (rows, 3), dtype=torch.uint8, device=card, generator=gen)
    s = torch.tensor([0.01, 0.02, 0.003], device=card)
    b = torch.tensor([-1.0, 0.5, 2.0], device=card)
    got = ops.dequant_rows(x, s, b, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert x.numel() > 2**31
    step = 2**26
    for lo in range(0, rows, step):
        sl = slice(lo, min(rows, lo + step))
        assert torch.equal(got[sl], ref.dequant_u8_ref(x[sl], s, b, torch.bfloat16)), lo
    del got, x
    torch.cuda.empty_cache()


def test_device_feed_on_card_matches_host_decode(card, tmp_path):
    rng = np.random.default_rng(0)
    root = str(tmp_path / "imgs")
    builder = DatasetBuilder(root, {"image": ((8, 8, 3), "float32"), "label": ((), "int32")},
                             shard_rows=100, quantize={"image": "u8"})
    builder.append(image=rng.random((300, 8, 8, 3)).astype(np.float32),
                   label=rng.integers(0, 10, 300).astype(np.int32))
    builder.finish()
    host = DataLoader(RaDataset(root), 16, seed=7)
    dev = DeviceLoader(DataLoader(RaDataset(root), 16, seed=7, reuse_buffers=True))
    try:
        assert dev.device == card
        for _ in range(6):
            hb, db = next(host), next(dev)
            assert db["image"].device.type == "cuda"
            assert hb["_state"].__dict__ == db["_state"].__dict__
            assert np.array_equal(db["image"].cpu().numpy(), hb["image"])
            assert np.array_equal(db["label"].cpu().numpy(), hb["label"])
    finally:
        host.stop()
        dev.stop()


TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py:19


def _normal(rng, shape, dtype, card):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(card, dtype)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd", [
    (2, 4, 2, 130, 130, 64),    # tail tiles on both axes
    (1, 2, 2, 1, 1, 32),        # one row
    (1, 8, 2, 96, 160, 128),    # Sk > Sq
    (2, 4, 2, 130, 130, 256),   # hd 256 (gemma3): f32 in q tiles of 32 rows
    (1, 4, 2, 96, 160, 256),    # hd 256, Sk > Sq
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40), (False, 0)])
def test_flash_attention_kernel_matches_plain_version(card, B, H, KV, Sq, Sk, hd, dtype,
                                                      causal, window):
    rng = np.random.default_rng(3)
    q = _normal(rng, (B, H, Sq, hd), dtype, card)
    k, v = (_normal(rng, (B, KV, Sk, hd), dtype, card) for _ in range(2))
    before, before_tc = fa.launches, fa.tc_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert fa.tc_launches == before_tc + (dtype == torch.bfloat16)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", [
    (1, 2, 2, 1, 1, 128, True, 0),        # Sq = Sk = 1: one tile, the ring's first phase only
    (2, 4, 2, 130, 130, 128, True, 0),    # a tail tile of 2 rows
    (1, 8, 1, 200, 200, 64, True, 0),     # 200 rows, g = 8
    (1, 8, 4, 96, 160, 128, True, 0),     # Sk > Sq
    (1, 8, 4, 96, 160, 64, False, 0),     # Sk > Sq, non-causal
    (2, 4, 2, 300, 300, 128, True, 40),   # window 40: rows 167..255 see no live key in tile 0
    (2, 4, 2, 576, 576, 128, True, 64),   # window 64 across tile edges, the serving width
    (1, 2, 1, 384, 384, 64, True, 100),   # window 100: a q tile's first visited tile is dead
                                          # for most of its rows (self-healing through alpha = 0)
    (2, 4, 4, 256, 256, 32, True, 0),     # hd 32 (64-byte swizzle), g = 1
    (2, 4, 2, 200, 200, 32, False, 0),    # hd 32, non-causal
    (1, 8, 1, 257, 257, 64, True, 64),    # hd 64, window, g = 8, one row past two tiles
    (2, 16, 8, 576, 576, 128, True, 0),   # the serving prefill's tile walk, 2 of 8 sequences
    (1, 2, 2, 5, 0, 64, False, 0),        # Sk = 0: no tile to visit, the output is zeros
    (1, 2, 1, 2080, 2080, 256, True, 0),  # hd 256 (gemma3): 64-row K/V tiles, setmaxnreg
    (1, 2, 1, 2080, 2080, 256, True, 1024),  # gemma3's local window across 16 K tiles
    (1, 4, 4, 96, 160, 256, True, 0),     # hd 256, Sk > Sq, g = 1
    (2, 4, 2, 130, 130, 256, True, 0),    # hd 256, a tail tile of 2 rows
    (1, 4, 2, 300, 300, 256, False, 0),   # hd 256, non-causal
    (1, 2, 2, 5, 0, 256, False, 0),       # hd 256, Sk = 0
])
def test_flash_attention_tensor_core_kernel_matches_plain_version(card, B, H, KV, Sq, Sk, hd,
                                                                  causal, window):
    """bf16 on the tensor cores: within 2e-2 of the f32 plain version (P is
    rounded to bf16 for P·V, about 2^-9·max|v| per output)."""
    rng = np.random.default_rng(Sq + Sk + hd + window)
    q = _normal(rng, (B, H, Sq, hd), torch.bfloat16, card)
    k, v = (_normal(rng, (B, KV, Sk, hd), torch.bfloat16, card) for _ in range(2))
    before, before_tc = fa.launches, fa.tc_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (fa.launches, fa.tc_launches) == (before + 1, before_tc + 1)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of each gradient's max |entry|


_BWD_SHAPES = [
    (2, 4, 4, 256, 64, True, 0),       # paper_lm's heads (groups of 1)
    (2, 16, 8, 300, 128, True, 0),     # InternLM2's heads, a ragged tail
    (1, 16, 8, 1100, 128, True, 1024),  # a window across many K/V tiles
    (2, 4, 2, 100, 32, True, 0),       # hd 32, ragged
    (1, 8, 1, 130, 64, True, 0),       # groups of 8
    (1, 4, 4, 200, 128, False, 0),     # non-causal
    (2, 16, 8, 192, 128, True, 0),     # a multiple of the 64-row tiles, not of 128
]
_BWD_CASES = [(*shape, dtype) for dtype in (torch.float32, torch.bfloat16)
              for shape in _BWD_SHAPES] + [
    # head width 256 (bf16 only: the f32 kernels stop at 128), gemma3's group of 2
    (2, 16, 8, 300, 256, True, 0, torch.bfloat16),      # global, a ragged tail
    (1, 16, 8, 2100, 256, True, 1024, torch.bfloat16),  # its window, across many tiles
    (1, 4, 1, 65, 256, True, 0, torch.bfloat16),        # groups of 4, one row past a tile
]


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window,dtype", _BWD_CASES)
def test_flash_attention_backward_kernel_matches_plain_version(card, B, H, KV, S, hd, causal,
                                                               window, dtype):
    """dq, dk, dv of ``csrc/flash_attention_bwd.cu`` against
    ``ref.flash_attention_bwd_ref`` on the same inputs (and the forward
    kernel's log-sum-exp against the plain one); two calls bit-equal."""
    rng = np.random.default_rng(S + hd + window)
    q, do = (_normal(rng, (B, H, S, hd), dtype, card) for _ in range(2))
    k, v = (_normal(rng, (B, KV, S, hd), dtype, card) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    _, want_lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                          return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal, window=window)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and torch.equal(g, a), name
        tol = BWD_TOL[dtype] * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=BWD_TOL[dtype], atol=tol,
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_with_one_key(card, dtype):
    """S = 1: the softmax over one key has no gradient, so dq = dk = 0 in
    exact arithmetic and dv = dO. What the kernel computes for dq and dk is
    the rounding of dP − D, two f32 sums of hd products taken in different
    orders, each off by at most hd · 2^-24 · hd · max|dO| · max|V|: so
    |dq|, |dk| <= hd² · 2^-23 · scale · max|dO| · max|V| · max|K|."""
    rng = np.random.default_rng(1)
    q, do = (_normal(rng, (1, 4, 1, 64), dtype, card) for _ in range(2))
    k, v = (_normal(rng, (1, 2, 1, 64), dtype, card) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, do, lse)
    torch.cuda.synchronize()
    want_dv = ref.flash_attention_bwd_ref(q, k, v, out, do, lse)[2]
    torch.testing.assert_close(dv.float(), want_dv.float(), rtol=BWD_TOL[dtype],
                               atol=BWD_TOL[dtype] * float(want_dv.float().abs().max()))
    bound = 64 ** 2 * 2.0 ** -23 * 64 ** -0.5 * float(
        do.float().abs().max() * v.float().abs().max() * k.float().abs().max())
    for name, g in (("dq", dq), ("dk", dk)):
        assert float(g.float().abs().max()) <= bound, name


def test_flash_attention_backward_raises_where_not_instantiated(card):
    """bf16 at head width 256 runs; a dtype or width the backward kernels do
    not take raises, with no fallback to the plain version."""
    q = torch.randn(1, 2, 64, 256, device=card, dtype=torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, q, q, return_lse=True)
    before = fa.bwd_launches
    grads = fa.flash_attention_bwd(q, q, q, out, q, lse)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    assert all(g.shape == q.shape and torch.isfinite(g.float()).all() for g in grads)
    q32 = q.float()
    with pytest.raises(RawArrayError, match="head_dim"):
        fa.flash_attention_bwd(q32, q32, q32, q32, q32, lse)
    q48 = torch.randn(1, 2, 64, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(RawArrayError, match="head_dim"):
        fa.flash_attention_bwd(q48, q48, q48, q48, q48, lse)
    q16 = torch.randn(1, 2, 64, 64, device=card, dtype=torch.float16)
    with pytest.raises(RawArrayError, match="float32 or bfloat16"):
        fa.flash_attention_bwd(q16, q16, q16, q16, q16, lse)
    assert fa.bwd_launches == before + 1


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("field", range(5))
def test_flash_attention_backward_refuses_a_plan_not_its_own(card, monkeypatch, hd, field):
    """The bf16 kernels launch only with the tiles ``bwd_geometry`` plans
    being their own, and an LSE/D stride of whole 64-row ring tiles: a plan
    with any one number off raises and launches nothing, so the CPU
    schedule test cannot check a stale copy of the kernels' tiles."""
    q = torch.randn(1, 2, 130, hd, device=card, dtype=torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, q, q, return_lse=True)
    plan = fa.bwd_geometry

    def off(S, width):
        dq_tiles, kv_tiles, S_pad = plan(S, width)
        flat = [*dq_tiles, *kv_tiles, S_pad]
        flat[field] += 32 if field < 4 else -64  # a tile resized; S_pad short of S
        return tuple(flat[:2]), tuple(flat[2:4]), flat[4]

    monkeypatch.setattr(fa, "bwd_geometry", off)
    before = fa.bwd_launches
    with pytest.raises(RawArrayError, match="launch failed"):
        fa.flash_attention_bwd(q, q, q, out, q, lse)
    assert fa.bwd_launches == before


def test_flash_attention_under_grad_raises_before_the_forward(card):
    """Under grad, bf16 at head width 256 runs the forward and, on
    ``backward()``, the backward kernel; at a width the backward lacks for
    its dtype (f32 at 256) the call raises before the forward kernel
    launches, and without grad it runs."""
    q = torch.randn(1, 2, 64, 256, device=card, dtype=torch.bfloat16, requires_grad=True)
    before = (fa.launches, fa.bwd_launches)
    ops.flash_attention(q, q, q).float().sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert q.grad is not None and torch.isfinite(q.grad.float()).all()
    q32 = q.detach().float().requires_grad_()
    with pytest.raises(RawArrayError, match="head_dim"):
        ops.flash_attention(q32, q32, q32)
    assert fa.launches == before[0] + 1
    with torch.no_grad():
        ops.flash_attention(q32, q32, q32)
    assert fa.launches == before[0] + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_launches_both_kernels(card, dtype):
    """``ops.flash_attention`` under grad: one forward launch, one backward
    call, and the gradients of the plain version under PyTorch's autograd."""
    rng = np.random.default_rng(9)
    q0 = _normal(rng, (2, 8, 200, 128), dtype, card)
    k0, v0 = (_normal(rng, (2, 4, 200, 128), dtype, card) for _ in range(2))
    do = _normal(rng, (2, 8, 200, 128), dtype, card)
    q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
    before = (fa.launches, fa.bwd_launches)
    got = torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    q, k, v = (t.float().requires_grad_() for t in (q0, k0, v0))
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v), (q, k, v), do.float())
    for g, w in zip(got, want):
        tol = BWD_TOL[dtype] * float(w.abs().max())
        torch.testing.assert_close(g.float(), w, rtol=BWD_TOL[dtype], atol=tol)


def test_dense_train_step_on_card_matches_cpu(card):
    """A reduced dense model's loss and gradients on the card (flash forward
    and backward kernels, one launch each a layer) against the same model on
    the CPU (the plain versions), in f32."""
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_params

    cfg = get_config("internlm2_1_8b").reduced()
    models = [build_model(cfg, device=d, seed=0) for d in ("cpu", card)]
    load_params(models[1], models[0].param_tree())  # the same weights on both
    for m in models:
        m.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 96))
                              .astype(np.uint32))
    losses = []
    before = (fa.launches, fa.bwd_launches)
    for m in models:
        loss, _ = m.train_loss({"tokens": tokens})
        loss.backward()
        losses.append(float(loss))
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before[0] + cfg.n_layers, before[1] + cfg.n_layers)
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    cpu, dev = (flatten(m.param_tree(), "param") for m in models)
    for name, p in cpu.items():
        tol = 1e-3 * float(p.grad.abs().max())
        torch.testing.assert_close(dev[name].grad.cpu(), p.grad, rtol=1e-3, atol=tol, msg=name)


@pytest.mark.parametrize("B,KV,g,S,hd,pos,window", [
    (1, 2, 4, 256, 64, 100, 0),
    (2, 1, 8, 512, 128, 511, 0),
    (2, 4, 1, 128, 64, 0, 0),
    (3, 2, 6, 300, 32, 299, 64),
    (8, 8, 2, 576, 128, 575, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain_version(card, B, KV, g, S, hd, pos, window,
                                                       dtype):
    rng = np.random.default_rng(4)
    q = _normal(rng, (B, KV * g, hd), dtype, card)
    k, v = (_normal(rng, (B, KV, S, hd), dtype, card) for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=card)
    before = da.launches
    got = ops.decode_attention(q, k, v, p, window=window)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    want = ref.decode_attention_ref(q.reshape(B, KV, g, hd), k, v, pos, window=window)
    torch.testing.assert_close(got.float(), want.reshape(B, KV * g, hd).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    # rows past pos are dead, whatever they hold
    k[:, :, pos + 1:] = 999.0
    v[:, :, pos + 1:] = float("nan")
    again = ops.decode_attention(q, k, v, p, window=window)
    assert torch.equal(again, got)


# (B, KV, g, S, hd, pos, window, cluster on a 132-SM card)
DECODE_CLUSTER_CASES = [
    (8, 8, 2, 576, 128, 575, 0, 2),         # the serving shape: 2 CTAs of 288 keys
    (8, 8, 2, 576, 128, 0, 0, 2),           # pos 0: one live key, CTA 1 without one
    (8, 8, 2, 576, 128, 287, 0, 2),         # pos on CTA 0's last key
    (8, 8, 2, 576, 128, 288, 0, 2),         # pos on CTA 1's first key
    (8, 8, 2, 576, 128, 328, 0, 2),         # pos mid-way through CTA 1's first tile
    (2, 8, 2, 576, 128, 300, 100, 4),       # a window across two CTAs of 144 keys (128 CTAs
                                            # in clusters of 8 would not all fit at once)
    (1, 8, 2, 576, 128, 143, 0, 8),         # pos on CTA 1's last key at cluster 8
    (1, 8, 2, 4096, 128, 4095, 0, 8),       # 512 keys a CTA
    (1, 2, 5, 200, 64, 150, 0, 4),          # g 5 (Qwen2.5-14B's 40/8): one head a CTA
    (1, 1, 8, 100, 32, 99, 0, 2),           # g 8, hd 32, two CTAs of 50 keys
    (32, 8, 1, 300, 64, 299, 0, 1),         # B·KV fills the card: no split
    (2, 4, 1, 40, 32, 17, 8, 1),            # S 40: too short to split, window 8
    (4, 8, 2, 2080, 256, 2079, 0, 2),       # gemma3's decode, hd 256: 64 CTAs of 1,040 keys
    (4, 8, 2, 2080, 256, 2079, 1024, 2),    # and its local layers' window across both CTAs
    (1, 8, 1, 576, 256, 300, 0, 8),         # hd 256, g 1, pos mid-way
    (1, 2, 8, 576, 256, 575, 100, 8),       # hd 256, g 8, a window across CTAs
    (32, 8, 2, 300, 256, 0, 0, 1),          # hd 256, no split, pos 0
]


@pytest.mark.parametrize("B,KV,g,S,hd,pos,window,cluster", DECODE_CLUSTER_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_cluster_kernel_matches_plain_version(card, B, KV, g, S, hd, pos,
                                                               window, cluster, dtype):
    """Every cluster size, pos at 0, on a CTA boundary and mid-tile, windows
    across CTAs, g 1/2/5/8 and hd 32/64/128; rows past pos hold NaN."""
    assert da.geometry(B, KV, g, S, 132)[0] == cluster
    rng = np.random.default_rng(S + pos + g)
    q = _normal(rng, (B, KV * g, hd), dtype, card)
    k, v = (_normal(rng, (B, KV, S, hd), dtype, card) for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=card)
    want = ref.decode_attention_ref(q.reshape(B, KV, g, hd), k, v, p, window=window)
    k[:, :, pos + 1:] = float("nan")
    v[:, :, pos + 1:] = float("nan")
    before = da.launches
    got = ops.decode_attention(q, k, v, p, window=window)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.reshape(B, KV * g, hd).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_decode_attention_is_one_kernel_per_call(card):
    """One device event per call in a profiler trace: no fold kernel, no
    scratch fill, no copy of pos."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(7)
    q = _normal(rng, (8, 16, 128), torch.bfloat16, card)
    k, v = (_normal(rng, (8, 8, 576, 128), torch.bfloat16, card) for _ in range(2))
    p = torch.tensor(575, dtype=torch.int32, device=card)
    ops.decode_attention(q, k, v, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.decode_attention(q, k, v, p)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and e.name != "Activity Buffer Request"]
    assert len(names) == 3 and all("decode_attention_kernel" in n for n in names), names


def test_decode_step_does_not_sync_with_the_host(card):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("internlm2_1_8b").reduced()
    model = build_model(cfg, device=card, seed=0)
    tokens = torch.randint(1, cfg.vocab, (2, 12), device=card)
    with torch.inference_mode():
        _, cache = model.prefill(tokens)
        cache["pos"] = torch.full((), 8, dtype=torch.int32, device=card)
        step = tokens[:, 8:9]
        logits, cache = model.decode_step(cache, step)  # builds and loads the kernels
        step = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                logits, cache = model.decode_step(cache, step)
                step = logits.argmax(-1, keepdim=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(cache["pos"]) == 12


def _ssd_inputs(rng, B, H, L, P, N, dtype, card, slow=False):
    x = _normal(rng, (B, H, L, P), dtype, card) * 0.5
    hi = 0.01 if slow else 0.3
    dtA = torch.from_numpy(-rng.uniform(0, hi, (B, H, L)).astype(np.float32)).to(card)
    Bm, Cm = (_normal(rng, (B, L, N), dtype, card) * 0.5 for _ in range(2))
    return x, dtA, Bm, Cm


@pytest.mark.parametrize("B,H,L,P,N,chunk,slow", [
    (1, 2, 128, 32, 16, 32, False),     # tests/test_kernels.py's sweep
    (2, 3, 256, 64, 32, 64, False),
    (1, 1, 64, 16, 8, 64, False),       # one chunk
    (2, 4, 100, 64, 64, 128, False),    # Q = 100
    (1, 4, 512, 64, 128, 128, True),    # slow decay: the state crosses every chunk
    (2, 8, 256, 64, 128, 128, False),   # Mamba2-780M's P and N
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain_version(card, B, H, L, P, N, chunk, slow, dtype):
    """y within rtol 1e-3 / atol 1e-4 (tests/test_kernels.py:79) in f32, 2e-2
    of its scale in bf16; the f32 final state within 1e-3 of its scale."""
    rng = np.random.default_rng(L + P + N)
    x, dtA, Bm, Cm = _ssd_inputs(rng, B, H, L, P, N, dtype, card, slow)
    before, before_tc = ssd.launches, ssd.tc_launches
    got, state = ops.ssd_scan(x, dtA, Bm, Cm, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert ssd.tc_launches == before_tc + (dtype == torch.bfloat16)
    want, want_state = ref.ssd_scan_ref(x, dtA, Bm, Cm, chunk=min(chunk, L))
    assert got.dtype == dtype and state.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    else:
        tol = 2e-2 * float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    tol = 1e-3 * max(1.0, float(want_state.abs().max()))
    torch.testing.assert_close(state, want_state, rtol=1e-3, atol=tol)
    # y alone, without the state, is the same launch's y
    again = ops.ssd_scan(x, dtA, Bm, Cm, chunk=chunk)
    assert torch.equal(again, got)


@pytest.mark.parametrize("B,H,L,P,N,chunk,slow", [
    (2, 4, 100, 64, 128, 128, False),   # Q 100: the chunk padded to 112 and masked
    (2, 4, 256, 64, 128, 128, False),   # Q 128, two chunks
    (1, 3, 128, 16, 8, 64, False),      # N 8 (half a k16 step), P 16
    (2, 2, 192, 32, 16, 64, False),     # N 16, P 32
    (1, 4, 256, 64, 64, 128, False),    # N 64
    (2, 2, 120, 32, 32, 40, False),     # Q 40: three chunks padded to 48
    (1, 2, 4096, 64, 128, 128, True),   # slow decay over 32 chunks
    (2, 4, 128, 32, 128, 128, False),   # a single chunk
])
def test_ssd_scan_tensor_core_kernels_match_plain_version(card, B, H, L, P, N, chunk, slow):
    """bf16 on the tensor cores: y within 2e-2 of its scale, the f32 final
    state within 1e-3 of its scale (G ⊙ L in bf16, state and decayed x in
    TF32)."""
    rng = np.random.default_rng(L + P + N + chunk)
    x, dtA, Bm, Cm = _ssd_inputs(rng, B, H, L, P, N, torch.bfloat16, card, slow)
    before, before_tc = ssd.launches, ssd.tc_launches
    got, state = ops.ssd_scan(x, dtA, Bm, Cm, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert (ssd.launches, ssd.tc_launches) == (before + 1, before_tc + 1)
    want, want_state = ref.ssd_scan_ref(x, dtA, Bm, Cm, chunk=min(chunk, L))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    tol = 2e-2 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    tol = 1e-3 * max(1.0, float(want_state.abs().max()))
    torch.testing.assert_close(state, want_state, rtol=1e-3, atol=tol)


def test_mamba2_decode_step_does_not_sync_with_the_host(card):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("mamba2_780m").reduced()
    model = build_model(cfg, device=card, seed=0)
    tokens = torch.randint(1, cfg.vocab, (2, 64), device=card)
    with torch.inference_mode():
        before = ssd.launches
        logits, cache = model.prefill(tokens)  # builds and loads the kernel
        assert ssd.launches == before + cfg.n_layers
        step = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                logits, cache = model.decode_step(cache, step)
                step = logits.argmax(-1, keepdim=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(cache["pos"]) == 67 and torch.isfinite(logits).all()


def test_zamba2_on_card_matches_cpu(card):
    """A reduced Zamba2 (f32, 4 Mamba2 layers, the shared block twice) on the
    card against the same model on the CPU (the plain versions): the prefill
    launches one flash call an invocation and one ``ssd_scan`` a layer; the
    engine's prompt replay launches one ``decode_attention`` an invocation a
    step, and a decode step syncs nothing with the host. The shared
    attention is tempered to its contraction width, as ``chip_smoke.py``
    tempers its models: at the init scales its softmax is all but an argmax."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_params

    cfg = get_config("zamba2_1_2b").reduced()
    models = [build_model(cfg, device=d, seed=0) for d in ("cpu", card)]
    attn, width = models[0].shared.attn, 2 * cfg.d_model
    with torch.no_grad():
        for name, factor in (("wq", cfg.n_heads / width), ("wk", cfg.n_kv_heads / width),
                             ("wv", cfg.n_kv_heads / width), ("wo", 1 / cfg.n_heads)):
            getattr(attn, name).mul_(factor ** 0.5)
    load_params(models[1], models[0].param_tree())  # the same weights on both
    n_inv = len(models[1].invocations)
    B, S = 2, 64
    tokens = torch.from_numpy(np.random.default_rng(5).integers(1, cfg.vocab, (B, S)))

    def close(got, want):
        tol = 1e-3 * float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=tol)

    with torch.inference_mode():
        before = (fa.launches, ssd.launches)
        want, _ = models[0].prefill(tokens)
        got, _ = models[1].prefill(tokens.to(card))
        torch.cuda.synchronize()
        assert (fa.launches, ssd.launches) == (before[0] + n_inv, before[1] + cfg.n_layers)
        close(got, want)

        caches = [m.empty_cache(B, S + 4) for m in models]
        before = da.launches
        for t in range(S):
            want, caches[0] = models[0].decode_step(caches[0], tokens[:, t:t + 1])
            got, caches[1] = models[1].decode_step(caches[1], tokens[:, t:t + 1].to(card))
        torch.cuda.synchronize()
        assert da.launches == before + n_inv * S
        close(got, want)

        step = got.argmax(-1, keepdim=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                got, caches[1] = models[1].decode_step(caches[1], step)
                step = got.argmax(-1, keepdim=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(caches[1]["pos"]) == S + 3 and torch.isfinite(got).all()
    assert da.launches == before + n_inv * (S + 3)
