"""Tests of the port that need a CUDA card: each hand-written kernel against
its plain PyTorch version (the attention's backward too), the device feed
on the card against the host decode (a mesh feed's global DTensors over
a one-rank NCCL group too), a sharded cold start on the card, a URL cold
start and a URL feed on the card against the local ones, a dense train
step and a reduced whisper's train step (its cross-attention's backward at
Sq != Sk), a reduced Zamba2's serving path and a reduced llava's prefill
with patches on the card against the CPU's, and dense, Whisper, Mamba2 and
Zamba2 decode steps that must not sync with the host; the attention kernels
at the moe family's widths (112, MLA's (192, 128) and (576, 512)), their
backward at 112 and (192, 128), moe decode steps and a moe train step on
the card. Each skips without a
card. This file imports nothing of JAX, so it runs on a machine that has a
card and no JAX:

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


@pytest.fixture
def one_rank_group(card):
    """A mesh test starts a one-rank process group in this process; it is
    gone again after the test."""
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_feed_on_card_is_global_and_matches_host_decode(card, tmp_path, one_rank_group):
    """A one-host mesh loader's global feed on the card: a one-rank NCCL
    group, DTensor batches whose local blocks the dequant kernel decoded,
    bit-equal to the host decode of the same rows, one launch a batch."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.data_mesh import DataMesh

    rng = np.random.default_rng(1)
    root = str(tmp_path / "imgs")
    builder = DatasetBuilder(root, {"image": ((8, 8, 3), "float32"), "label": ((), "int32")},
                             shard_rows=32, quantize={"image": "u8"})
    builder.append(image=rng.random((256, 8, 8, 3)).astype(np.float32),
                   label=rng.integers(0, 10, 256).astype(np.int32))
    builder.finish()
    host = DataLoader(RaDataset(root), 16, seed=7, dequant=True, mesh=DataMesh("h0", ["h0"]))
    dev = DeviceLoader(DataLoader(RaDataset(root), 16, seed=7, reuse_buffers=True,
                                  mesh=DataMesh("h0", ["h0"])))
    try:
        assert dev.global_arrays and dist.get_backend() == "nccl"
        before = dq.launches
        for _ in range(6):
            hb, db = next(host), next(dev)
            assert hb["_state"].__dict__ == db["_state"].__dict__
            for f in ("image", "label"):
                assert isinstance(db[f], DTensor) and db[f].device_mesh.device_type == "cuda"
                local = db[f].to_local()
                assert local.device == card
                assert np.array_equal(local.cpu().numpy(), hb[f]), f
        torch.cuda.synchronize()
        assert dq.launches - before >= 6
    finally:
        host.stop()
        dev.stop()


def test_sharded_restore_on_card_matches_host_decode(card, tmp_path, one_rank_group):
    """A u8 checkpoint restored onto a one-rank NCCL mesh: sharded leaves are
    DTensors on the card, decoded on the host (bit-equal to the plain
    decode), an unsharded u8 leaf still goes through the kernel."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import load_checkpoint, restore_pipelined, save_checkpoint
    from repro_torch.checkpoint import shardings_from_specs
    from repro_torch.distributed.data_mesh import data_sharding

    rng = np.random.default_rng(4)
    tree = {"w": torch.from_numpy(rng.standard_normal((64, 130)).astype(np.float32)),
            "v": torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32))}
    path = save_checkpoint(str(tmp_path / "ck"), 1, tree, quantize="u8")
    mesh = data_sharding(device=card)[0]
    sh = shardings_from_specs(mesh, {"w": ("data", None), "v": None})
    before = dq.launches
    got, _, _ = restore_pipelined(path, tree, device=card, shardings=sh)
    plain, _, _ = load_checkpoint(path, tree)
    assert dq.launches == before
    for name in tree:
        assert isinstance(got[name], DTensor)
        assert torch.equal(got[name].to_local().cpu(), plain[name]), name
    unsharded, _, _ = restore_pipelined(path, tree, device=card, shardings={"w": None, "v": sh["v"]})
    assert dq.launches == before + 1
    assert torch.equal(unsharded["w"].cpu(), plain["w"])


def test_url_cold_start_and_feed_on_card_match_local(card, tmp_path):
    """From a byte-range server: a u8 and a bf16 checkpoint restored onto
    the card (pinned host buffers filled by ranged reads, codes decoded by
    the kernel) equal the local restore, and a URL feed's batches equal the
    local feed's."""
    from repro_torch import remote
    from repro_torch.checkpoint import ColdStartStats, restore_pipelined, save_checkpoint

    rng = np.random.default_rng(3)
    tree = {"w": torch.from_numpy(rng.standard_normal((96, 130)).astype(np.float32)),
            "e": torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32)).bfloat16()}
    builder = DatasetBuilder(str(tmp_path / "imgs"), {"image": ((8, 8, 3), "float32")},
                             quantize={"image": "u8"})
    builder.append(image=rng.random((64, 8, 8, 3)).astype(np.float32))
    builder.finish()
    server = remote.serve(str(tmp_path), port=0)
    try:
        for step, kw in ((1, {"quantize": "u8"}), (2, {"chunked": True})):
            path = save_checkpoint(str(tmp_path / "ck"), step, tree, **kw)
            local, _, _ = restore_pipelined(path, tree, device=card)
            st = ColdStartStats()
            before = dq.launches
            got, _, _ = restore_pipelined(f"{server.url}/ck/step_{step:08d}", tree,
                                          device=card, stats=st)
            assert dq.launches - before == st.dequant_leaves == (1 if kw.get("quantize") else 0)
            for name in tree:
                assert got[name].device == card and torch.equal(got[name], local[name])
        feeds = [DeviceLoader(DataLoader(RaDataset(root), 16, seed=7, reuse_buffers=True))
                 for root in (str(tmp_path / "imgs"), f"{server.url}/imgs")]
        try:
            for _ in range(4):
                a, b = (next(f) for f in feeds)
                assert torch.equal(a["image"], b["image"])
        finally:
            for f in feeds:
                f.stop()
    finally:
        server.shutdown()
        server.server_close()
        remote.close_readers()


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
    (1, 16, 16, 1500, 1500, 64, False, 0),  # whisper's encoder: g 1, hd 64, 1,500 frames
    (2, 16, 16, 128, 1500, 64, False, 0),   # whisper's cross-attention: 128 rows over 1,500
    (1, 8, 2, 4352, 4352, 128, True, 4096),  # llava's prefill (1,152 + 3,200), past its window
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
    _, lse, out = fa.flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
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


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", [
    (2, 4, 2, 64, 200, 64, False, 0),     # small, non-causal
    (1, 8, 8, 130, 1500, 64, False, 0),   # whisper's cross-attention, ragged on both sides
    (1, 4, 2, 100, 300, 128, True, 0),    # causal Sk > Sq: keys 100.. seen by no row
    (1, 4, 2, 300, 100, 128, True, 0),    # causal Sq > Sk
    (1, 4, 4, 1, 300, 64, False, 0),      # one row over many keys
    (1, 4, 2, 200, 330, 64, True, 64),    # a window
    (2, 4, 4, 24, 64, 32, False, 0),      # the reduced whisper's cross-attention, hd 32
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_at_sq_ne_sk(card, B, H, KV, Sq, Sk, hd, causal,
                                                     window, dtype):
    """Sq q rows over Sk keys: dq, dk, dv of the kernels against
    ``ref.flash_attention_bwd_ref``, two calls bit-equal, and exact zeros in
    dk and dv for the keys no row sees (their CTAs walk nothing and store
    zeros over ``torch.empty_like``'s memory)."""
    rng = np.random.default_rng(Sq + Sk + hd)
    q, do = (_normal(rng, (B, H, Sq, hd), dtype, card) for _ in range(2))
    k, v = (_normal(rng, (B, KV, Sk, hd), dtype, card) for _ in range(2))
    _, lse, out = fa.flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal, window=window)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.equal(g, a), name
        tol = BWD_TOL[dtype] * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=BWD_TOL[dtype], atol=tol,
                                   msg=name)
    if causal and Sk > Sq:
        assert not got[1][:, :, Sq:].any() and not got[2][:, :, Sq:].any()


@pytest.mark.parametrize("Sq,Sk,hd", [(64, 1500, 64), (448, 1500, 64), (300, 300, 128)])
def test_flash_attention_backward_reads_d_from_the_f32_output(card, Sq, Sk, hd):
    """bf16 keys and values with a large common part (as whisper's encoder
    states have) and a softmax spread over many keys: the forward kernel's
    f32 output rounds to its bf16 output exactly, and ``ops.flash_attention``'s
    gradients (D from the f32 output) match PyTorch's autograd through the
    plain version in f32 within the bf16 tolerance."""
    rng = np.random.default_rng(Sq + Sk)
    B, H = 1, 4

    def shared(shape):  # rows sharing a common vector 3x their own spread
        a = rng.standard_normal(shape) + 3.0 * rng.standard_normal(shape[-1])
        return torch.from_numpy(a.astype(np.float32)).to(card, torch.bfloat16)

    q0, do = (_normal(rng, (B, H, Sq, hd), torch.bfloat16, card) for _ in range(2))
    k0, v0 = shared((B, H, Sk, hd)), shared((B, H, Sk, hd))
    out, _, out32 = fa.flash_attention_fwd(q0, k0, v0, causal=False, return_lse=True)
    torch.cuda.synchronize()
    assert out32.dtype == torch.float32 and torch.equal(out32.to(torch.bfloat16), out)
    q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=False), (q, k, v), do)
    q, k, v = (t.float().requires_grad_() for t in (q0, k0, v0))
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, causal=False), (q, k, v),
                               do.float())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        tol = BWD_TOL[torch.bfloat16] * float(w.abs().max())
        torch.testing.assert_close(g.float(), w, rtol=BWD_TOL[torch.bfloat16], atol=tol,
                                   msg=lambda m, name=name: f"{name}: {m}")


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
    _, lse, out = fa.flash_attention_fwd(q, k, v, return_lse=True)
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
    _, lse, out = fa.flash_attention_fwd(q, q, q, return_lse=True)
    before = fa.bwd_launches
    grads = fa.flash_attention_bwd(q, q, q, out, q, lse)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1
    assert all(g.shape == q.shape and torch.isfinite(g.float()).all() for g in grads)
    q32 = q.float()
    with pytest.raises(RawArrayError, match="head widths"):
        fa.flash_attention_bwd(q32, q32, q32, q32, q32, lse)
    q48 = torch.randn(1, 2, 64, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(RawArrayError, match="head widths"):
        fa.flash_attention_bwd(q48, q48, q48, q48, q48, lse)
    q16 = torch.randn(1, 2, 64, 64, device=card, dtype=torch.float16)
    with pytest.raises(RawArrayError, match="float32 or bfloat16"):
        fa.flash_attention_bwd(q16, q16, q16, q16, q16, lse)
    assert fa.bwd_launches == before + 1


@pytest.mark.parametrize("hd", [128, 256, (112, 112), (192, 128)])
@pytest.mark.parametrize("field", range(5))
def test_flash_attention_backward_refuses_a_plan_not_its_own(card, monkeypatch, hd, field):
    """The bf16 kernels launch only with the tiles ``bwd_geometry`` plans
    being their own, and an LSE/D stride of whole 64-row ring tiles: a plan
    with any one number off raises and launches nothing, so the CPU
    schedule test cannot check a stale copy of the kernels' tiles. ``hd``
    is a width for q, k and v, or a (q·k, v) pair."""
    dk, dv = hd if isinstance(hd, tuple) else (hd, hd)
    q = torch.randn(1, 2, 130, dk, device=card, dtype=torch.bfloat16)
    v = torch.randn(1, 2, 130, dv, device=card, dtype=torch.bfloat16)
    o, lse, out = fa.flash_attention_fwd(q, q, v, return_lse=True)
    plan = fa.bwd_geometry

    def off(S, dk, dv):
        dq_tiles, kv_tiles, S_pad = plan(S, dk, dv)
        flat = [*dq_tiles, *kv_tiles, S_pad]
        flat[field] += 32 if field < 4 else -64  # a tile resized; S_pad short of S
        return tuple(flat[:2]), tuple(flat[2:4]), flat[4]

    monkeypatch.setattr(fa, "bwd_geometry", off)
    before = fa.bwd_launches
    with pytest.raises(RawArrayError, match="launch failed"):
        fa.flash_attention_bwd(q, q, v, out, o, lse)
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
    with pytest.raises(RawArrayError, match="head widths"):
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


def test_whisper_train_step_on_card_matches_cpu(card):
    """A reduced whisper's loss and gradients on the card (2 encoder and 2
    decoder layers: 6 flash forward launches and 6 backward calls, the two
    cross-attentions' 24 rows over 64 frames among them) against the same
    model on the CPU (the plain versions), in f32."""
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_params

    cfg = get_config("whisper_medium").reduced()
    models = [build_model(cfg, device=d, seed=0) for d in ("cpu", card)]
    _temper_whisper(models[0])
    load_params(models[1], models[0].param_tree())
    for m in models:
        m.requires_grad_(True)
    rng = np.random.default_rng(5)
    batch = {"frames": torch.from_numpy((rng.standard_normal((2, cfg.enc_seq, cfg.d_model))
                                         * 0.1).astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(1, cfg.vocab, (2, 24)).astype(np.int32))}
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    losses = []
    before = (fa.launches, fa.bwd_launches)
    for m in models:
        loss, _ = m.train_loss(batch)
        loss.backward()
        losses.append(float(loss))
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before[0] + n_attn, before[1] + n_attn)
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    cpu, dev = (flatten(m.param_tree(), "param") for m in models)
    for name, p in cpu.items():
        tol = 1e-3 * float(p.grad.abs().max())
        torch.testing.assert_close(dev[name].grad.cpu(), p.grad, rtol=1e-3, atol=tol,
                                   msg=lambda m, name=name: f"{name}: {m}")


def _temper_whisper(model):
    """Every attention's projections scaled to their contraction width, as
    ``chip_smoke.py:_temper_attention`` and ``tests/test_torch_whisper.py``
    do: at the init scales the scores' softmax is all but an argmax, and two
    devices' f32 roundings then move gradients past any tolerance."""
    cfg = model.cfg
    d, H = cfg.d_model, cfg.n_heads
    with torch.no_grad():
        for a in (model.enc_layers.attn, model.dec_layers.self_attn,
                  model.dec_layers.cross_attn):
            for name, factor in (("wq", H / d), ("wk", H / d), ("wv", H / d), ("wo", 1 / H)):
                a[name].mul_(factor ** 0.5)


@pytest.mark.parametrize("B,KV,g,S,hd,pos,window", [
    (1, 2, 4, 256, 64, 100, 0),
    (2, 1, 8, 512, 128, 511, 0),
    (2, 4, 1, 128, 64, 0, 0),
    (3, 2, 6, 300, 32, 299, 64),
    (8, 8, 2, 576, 128, 575, 0),
    (2, 16, 1, 1500, 64, 1499, 0),  # whisper's cross-attention decode: every row live
    (2, 8, 4, 576, 128, 575, 0),    # llava's decode: g 4, hd 128
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


# the moe family's widths: Kimi-K2's 112, DeepSeek-V3's MLA prefill (192, 128)
@pytest.mark.parametrize("dk,dv", [(112, 112), (192, 128)])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,window", [
    (8, 8, 1, 576, 576, True, 0),     # kimi's group of 8 / MLA's engine prefill, one KV head
    (2, 4, 4, 130, 130, True, 0),     # a ragged tail tile
    (1, 4, 2, 96, 160, True, 0),      # Sk > Sq, S not a multiple of the tile
    (2, 4, 2, 200, 200, False, 0),    # non-causal
    (1, 2, 2, 300, 300, True, 40),    # a window
    (1, 2, 2, 1, 1, True, 0),         # one row
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_moe_widths_matches_plain_version(card, dk, dv, B, H, KV,
                                                                    Sq, Sk, causal, window,
                                                                    dtype):
    """Both kernels at (112, 112) (the tensor cores' tiles are 128 wide, TMA
    zero-fills the last 16 columns) and (192, 128) (Q and K tiles of three
    boxes, V of two): within the forward's tolerance of the plain version,
    and two calls bit-equal."""
    rng = np.random.default_rng(dk + Sq)
    q = _normal(rng, (B, H, Sq, dk), dtype, card)
    k = _normal(rng, (B, KV, Sk, dk), dtype, card)
    v = _normal(rng, (B, KV, Sk, dv), dtype, card)
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 2 and tuple(got.shape) == (B, H, Sq, dv)
    assert torch.equal(got, again)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dk,dv", [(112, 112), (192, 128)])
def test_flash_attention_backward_refuses_the_moe_widths(card, dk, dv):
    """The moe family's widths train in bf16 only: in f32, under grad and
    for the training forward, the call raises before any launch, saying
    that no model trains there in f32; in bf16 both run."""
    q = torch.randn(1, 2, 64, dk, device=card, requires_grad=True)
    v = torch.randn(1, 2, 64, dv, device=card)
    before = fa.launches, fa.bwd_launches
    with pytest.raises(RawArrayError, match="no model trains there in float32"):
        ops.flash_attention(q, q, v)
    with pytest.raises(RawArrayError, match="no model trains there in float32"):
        fa.flash_attention_fwd(q.detach(), q.detach(), v, return_lse=True)
    assert (fa.launches, fa.bwd_launches) == before
    qb = q.detach().bfloat16().requires_grad_()
    ops.flash_attention(qb, qb, v.bfloat16()).float().sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert qb.grad.shape == qb.shape and torch.isfinite(qb.grad.float()).all()


# (B, H, KV, Sq, Sk, causal, window): the moe family's training attention at its
# (q·k, v) pairs, the edges of their tiles (hd 128's at 112, 64-key tiles at (192, 128))
_MOE_BWD_SHAPES = [
    (1, 16, 2, 1024, 1024, True, 0),   # kimi's group of 8 over many tiles
    (2, 4, 4, 300, 300, True, 0),      # group 1 (the MLA's), a ragged tail
    (1, 4, 2, 130, 400, True, 0),      # causal Sk > Sq: keys 130.. seen by none, zeros
    (1, 4, 2, 400, 130, True, 0),      # causal Sq > Sk
    (1, 4, 4, 200, 333, False, 0),     # non-causal Sq != Sk, ragged both sides
    (1, 4, 2, 520, 520, True, 128),    # a window
    (1, 2, 2, 65, 65, True, 0),        # one row past a 64-row tile
]


@pytest.mark.parametrize("dk,dv", [(112, 112), (192, 128)])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal,window", _MOE_BWD_SHAPES)
def test_flash_attention_backward_kernel_at_moe_widths(card, dk, dv, B, H, KV, Sq, Sk, causal,
                                                       window):
    """bf16 dq, dk, dv at (112, 112) (tiles 128 wide over 112-wide maps, the
    stores at a 112 stride) and (192, 128) (dQ's K/V tiles of 64 keys; the
    dK/dV kernel's warpgroups split dV and dK): within 2e-2 of each
    gradient's largest entry of the plain backward, two calls bit-equal,
    exact zeros for keys no row sees; the training forward's f32 output
    rounds to its bf16 one and its LSE matches the plain one."""
    rng = np.random.default_rng(dk + Sq + Sk + window)
    q, do = _normal(rng, (B, H, Sq, dk), torch.bfloat16, card), \
        _normal(rng, (B, H, Sq, dv), torch.bfloat16, card)
    k = _normal(rng, (B, KV, Sk, dk), torch.bfloat16, card)
    v = _normal(rng, (B, KV, Sk, dv), torch.bfloat16, card)
    o, lse, out = fa.flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    _, want_lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (B, H, Sq, dv)
    assert torch.equal(out.to(torch.bfloat16), o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 2
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal, window=window)
    tol = BWD_TOL[torch.bfloat16]
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape and torch.equal(g, a), name
        torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                   atol=tol * float(w.float().abs().max()), msg=name)
    if causal and Sk > Sq:
        assert not got[1][:, :, Sq:].any() and not got[2][:, :, Sq:].any()


@pytest.mark.parametrize("dk,dv", [(112, 112), (192, 128)])
def test_training_forward_at_moe_widths_matches_plain_version(card, dk, dv):
    """The training instance of the forward at the moe pairs: its bf16 output
    within the forward's tolerance of the plain version and equal to the
    rounding of its f32 output, which is within 2^-8 of the plain f32 output
    (P carried to about 2^-16 by the second product), two calls bit-equal."""
    rng = np.random.default_rng(dk)
    B, H, KV, S = 2, 8, 2, 700
    q = _normal(rng, (B, H, S, dk), torch.bfloat16, card)
    k = _normal(rng, (B, KV, S, dk), torch.bfloat16, card)
    v = _normal(rng, (B, KV, S, dv), torch.bfloat16, card)
    o, lse, out = fa.flash_attention_fwd(q, k, v, return_lse=True)
    o2, lse2, out2 = fa.flash_attention_fwd(q, k, v, return_lse=True)
    want32 = ref.flash_attention_ref(q, k, v, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(out, out2)
    assert torch.equal(out.to(torch.bfloat16), o)
    torch.testing.assert_close(o.float(), want32, rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])
    torch.testing.assert_close(out, want32, rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("B,KV,g,S,pos,window", [
    (8, 8, 8, 576, 575, 0),     # kimi's decode: 64 heads over 8 KV heads
    (2, 8, 8, 576, 0, 0),       # pos 0
    (1, 2, 4, 300, 170, 64),    # a window
    (4, 1, 2, 100, 99, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_at_head_width_112(card, B, KV, g, S, pos, window, dtype):
    """A team of 16 lanes a key, 14 of them with data: within tolerance,
    rows past pos dead, two calls bit-equal."""
    rng = np.random.default_rng(S + pos)
    q = _normal(rng, (B, KV * g, 112), dtype, card)
    k, v = (_normal(rng, (B, KV, S, 112), dtype, card) for _ in range(2))
    p = torch.tensor(pos, dtype=torch.int32, device=card)
    want = ref.decode_attention_ref(q.reshape(B, KV, g, 112), k, v, p, window=window)
    k[:, :, pos + 1:] = float("nan")
    v[:, :, pos + 1:] = float("nan")
    before = da.launches
    got = ops.decode_attention(q, k, v, p, window=window)
    again = ops.decode_attention(q, k, v, p, window=window)
    torch.cuda.synchronize()
    assert da.launches == before + 2 and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.reshape(B, KV * g, 112).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,H,S,pos", [
    (8, 128, 576, 575),   # deepseek-v3's last engine step: 128 heads over one latent head
    (8, 128, 576, 0),     # pos 0
    (2, 128, 576, 17),    # pos inside the first tile
    (2, 16, 100, 99),     # a ragged last tile
    (1, 2, 40, 31),       # g 2: one CTA of 2 heads
])
def test_mla_decode_reads_v_from_the_key_rows(card, B, H, S, pos):
    """MLA's absorbed decode at (576, 512), bf16: V is the first 512 columns
    of each 576-wide cache row, passed as a view of K and read from K's
    tile; within tolerance of the plain version at MLA's scale, rows past
    pos dead, two calls bit-equal. A V of its own at this pair raises, as
    does a view of K at a pair that reads two caches."""
    rng = np.random.default_rng(S + pos + H)
    scale = 192 ** -0.5
    q = _normal(rng, (B, H, 576), torch.bfloat16, card)
    rows = _normal(rng, (B, 1, S, 576), torch.bfloat16, card)
    p = torch.tensor(pos, dtype=torch.int32, device=card)
    want = ref.decode_attention_ref(q[:, None], rows, rows[..., :512], p, scale=scale)[:, 0]
    rows[:, :, pos + 1:] = float("nan")
    before = da.launches
    got = ops.decode_attention(q, rows, rows[..., :512], p, scale=scale)
    again = ops.decode_attention(q, rows, rows[..., :512], p, scale=scale)
    torch.cuda.synchronize()
    assert da.launches == before + 2 and tuple(got.shape) == (B, H, 512)
    assert torch.equal(got, again) and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])
    with pytest.raises(RawArrayError, match="reads V from K's rows"):
        ops.decode_attention(q, rows, rows[..., :512].contiguous(), p, scale=scale)
    k128 = _normal(rng, (B, 1, S, 128), torch.bfloat16, card)
    with pytest.raises(RawArrayError, match="head widths"):
        ops.decode_attention(q[..., :128].contiguous(), k128, k128[..., :64], p)
    assert da.launches == before + 2


def _moe_on_card(arch):
    """A reduced moe config at its kernels' widths on the card, bf16:
    Kimi-K2 with head width 112, DeepSeek-V3 with its MLA widths."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced().with_(param_dtype="bfloat16", compute_dtype="bfloat16")
    if cfg.attn_type == "mla":
        return cfg.with_(mla=dataclasses.replace(
            cfg.mla, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128))
    return cfg.with_(head_dim=112)


@pytest.mark.parametrize("arch", ["kimi_k2_1t", "deepseek_v3_671b"])
def test_moe_decode_step_on_card_launches_the_kernels_without_a_sync(card, arch):
    """A moe model at its attention widths serves on the card: the prefill
    launches the flash kernel once a layer, each decode step the decode
    kernel once a layer, and a decode step (MoE dispatch included) does not
    sync with the host."""
    from repro_torch.models import build_model

    cfg = _moe_on_card(arch)
    model = build_model(cfg, device=card, seed=0)
    tokens = torch.randint(1, cfg.vocab, (2, 12), device=card)
    with torch.inference_mode():
        before = fa.launches, da.launches
        _, cache = model.prefill(tokens)
        cache["pos"] = torch.full((), 8, dtype=torch.int32, device=card)
        logits, cache = model.decode_step(cache, tokens[:, 8:9])
        torch.cuda.synchronize()
        assert (fa.launches, da.launches) == (before[0] + cfg.n_layers, before[1] + cfg.n_layers)
        step = logits.argmax(-1, keepdim=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                logits, cache = model.decode_step(cache, step)
                step = logits.argmax(-1, keepdim=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(cache["pos"]) == 12 and torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("arch", ["kimi_k2_1t", "deepseek_v3_671b"])
def test_moe_train_step_on_card_is_bit_equal_twice(card, arch):
    """A reduced moe model at its attention widths (Kimi-K2's 112, the MLA's
    (192, 128)) trains on the card in bf16: one flash forward and one
    backward launch an attention (each layer's, and DeepSeek-V3's MTP
    layer's), a finite loss with every metric, a gradient for every leaf, and
    two forward and backward passes give bit-equal gradients (the MoE
    dispatch's gathers, the expert products and both attention kernels
    alike), with routes that drop (capacity factor 0.5, two chunks)."""
    import dataclasses

    from repro_torch.checkpoint.store import flatten
    from repro_torch.models import build_model

    cfg = _moe_on_card(arch)
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, dispatch_chunks=2, capacity_factor=0.5))
    model = build_model(cfg, device=card, seed=0).requires_grad_(True)
    tokens = torch.randint(1, cfg.vocab, (2, 192), device=card)
    n_attn = cfg.n_layers + int(cfg.mtp)
    runs = []
    for _ in range(2):
        before = (fa.launches, fa.bwd_launches)
        loss, metrics = model.train_loss({"tokens": tokens})
        loss.backward()
        torch.cuda.synchronize()
        assert (fa.launches, fa.bwd_launches) == (before[0] + n_attn, before[1] + n_attn)
        assert set(metrics) == {"ce", "aux", "acc", "loss"} | ({"mtp"} if cfg.mtp else set())
        assert all(torch.isfinite(m).all() for m in metrics.values())
        grads = {n: p.grad.clone() for n, p in flatten(model.param_tree(), "param").items()}
        model.zero_grad(set_to_none=True)
        runs.append((float(loss), grads))
    assert runs[0][0] == runs[1][0]
    for name, g in runs[0][1].items():
        assert torch.isfinite(g.float()).all() and g.any(), name
        assert torch.equal(g, runs[1][1][name]), name


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


def test_whisper_decode_step_does_not_sync_with_the_host(card):
    """Both decode launches a layer (self-attention at ``pos``, cross-attention
    at S_audio - 1) take their positions on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention
    from repro_torch.models import build_model

    cfg = get_config("whisper_medium").reduced()
    model = build_model(cfg, device=card, seed=0)
    frames = torch.randn((2, cfg.enc_seq, cfg.d_model), device=card) * 0.1
    tokens = torch.randint(1, cfg.vocab, (2, 12), device=card)
    with torch.inference_mode():
        _, cache = model.prefill(frames, tokens)
        cache["pos"] = torch.full((), 8, dtype=torch.int32, device=card)
        logits, cache = model.decode_step(cache, tokens[:, 8:9])  # builds the kernels
        step = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        before = decode_attention.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                logits, cache = model.decode_step(cache, step)
                step = logits.argmax(-1, keepdim=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(cache["pos"]) == 12
    assert decode_attention.launches - before == 3 * 2 * cfg.n_layers


def test_vlm_prefill_with_patches_on_card_matches_cpu(card):
    """A reduced llava's prefill with patches past its window, on the card
    (the kernels) against the CPU (the plain versions), f32."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_params

    cfg = get_config("llava_next_mistral_7b").reduced()
    host = build_model(cfg, device="cpu", seed=0)
    model = build_model(cfg, device=card, seed=1)
    load_params(model, host.param_tree())
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 70)))
    patches = torch.from_numpy(rng.normal(size=(2, cfg.n_patches, cfg.d_model))
                               .astype(np.float32) * 0.1)
    want, want_cache = host.prefill(tokens, patches)
    got, cache = model.prefill(tokens.to(card), patches.to(card))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert int(cache["pos"]) == cfg.n_patches + 70
    torch.testing.assert_close(cache["dense"]["k"].cpu(), want_cache["dense"]["k"],
                               rtol=1e-4, atol=1e-4 * float(want_cache["dense"]["k"].abs().max()))


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


@pytest.mark.parametrize("B,H,L,P,N,chunk,slow", [
    (2, 4, 256, 64, 128, 128, False),   # Mamba2-780M's P and N, two chunks
    (2, 4, 256, 64, 64, 128, False),    # Zamba2-1.2B's N
    (2, 4, 200, 64, 128, 100, False),   # a runtime chunk below 128 (Q 100, padded to 128)
    (1, 4, 80, 64, 64, 40, False),      # Q 40: padded to 64
    (1, 4, 512, 64, 128, 128, True),    # slow decay: the gradient crosses every chunk
    (2, 3, 96, 32, 16, 32, False),      # the reduced configs' P and N
    (1, 2, 64, 32, 32, 64, False),      # one chunk
    (2, 9, 200, 32, 16, 100, False),    # P 32, N 16, Q 100; H 9: groups of 8 and 1
    (2, 12, 200, 32, 32, 100, False),   # P 32, N 32, Q 100; H 12: groups of 8 and 4
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_backward_kernel_matches_plain_version(card, B, H, L, P, N, chunk, slow,
                                                        dtype):
    """dx, d(dtA), dB and dC within f32 1e-4 / bf16 2e-2 of each gradient's
    largest entry (the attention backward's tolerance), one launch a call
    (bf16 on the tensor-core kernels, ``bwd_tc_launches``), two calls
    bit-equal; through ``ops.ssd_scan`` under grad the same gradients, by
    ``SsdScan``."""
    rng = np.random.default_rng(L + P + N + chunk)
    x, dtA, Bm, Cm = _ssd_inputs(rng, B, H, L, P, N, dtype, card, slow)
    dy = _normal(rng, (B, H, L, P), dtype, card)
    before, before_tc = ssd.bwd_launches, ssd.bwd_tc_launches
    got = ssd.ssd_scan_bwd(x, dtA, Bm, Cm, dy, chunk=chunk)
    again = ssd.ssd_scan_bwd(x, dtA, Bm, Cm, dy, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.bwd_launches == before + 2
    assert ssd.bwd_tc_launches == before_tc + (2 if dtype == torch.bfloat16 else 0)
    want = ref.ssd_scan_bwd_ref(x, dtA, Bm, Cm, dy, chunk=chunk)
    tol = BWD_TOL[dtype]
    for name, g, g2, w, t in zip(("dx", "ddtA", "dB", "dC"), got, again, want, (x, dtA, Bm, Cm)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        assert torch.equal(g, g2), name
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol * scale, msg=name)
    leaves = [t.detach().clone().requires_grad_() for t in (x, dtA, Bm, Cm)]
    before = (ssd.launches, ssd.bwd_launches)
    y = ops.ssd_scan(*leaves, chunk=chunk)
    assert type(y.grad_fn).__name__ == "SsdScanBackward"
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (ssd.launches, ssd.bwd_launches) == (before[0] + 1, before[1] + 1)
    for name, g, g2 in zip(("dx", "ddtA", "dB", "dC"), grads, got):
        assert torch.equal(g, g2), name


def test_ssd_scan_backward_refuses_what_it_cannot_take(card):
    """Under grad a shape the backward kernel is not instantiated for (N 8,
    P 16) raises before the forward runs; without grad the forward runs."""
    rng = np.random.default_rng(3)
    x, dtA, Bm, Cm = _ssd_inputs(rng, 1, 2, 64, 16, 8, torch.float32, card)
    before = (ssd.launches, ssd.bwd_launches)
    with pytest.raises(RawArrayError, match="backward kernel supports"):
        ops.ssd_scan(x.requires_grad_(), dtA, Bm, Cm, chunk=32)
    assert (ssd.launches, ssd.bwd_launches) == before
    with pytest.raises(RawArrayError, match="no backward"):
        ops.ssd_scan(x, dtA, Bm, Cm, chunk=32, return_state=True)
    with torch.no_grad():
        assert ops.ssd_scan(x, dtA, Bm, Cm, chunk=32).shape == x.shape
    assert ssd.launches == before[0] + 1


@pytest.mark.parametrize("arch,changes", [
    ("mamba2_780m", {"remat": True}),   # each layer's forward twice, its backward once
    ("zamba2_1_2b", {}),                # and the shared block's flash forward and backward
])
def test_ssm_train_step_on_card_matches_the_plain_backward(card, arch, changes):
    """A reduced ssm or hybrid model's loss and gradients on the card (the
    scan's forward and backward kernels) against the same step with the
    scan's backward swapped for its plain version (``ref.ssd_scan_bwd_ref``
    on the card), in f32: the loss equal, every gradient leaf within 1e-4 of
    its largest entry (the backward kernel's f32 tolerance); a second step
    with the kernel bit-equal to the first."""
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced().with_(**changes)
    model = build_model(cfg, device=card, seed=0).requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (2, 96))
                              .astype(np.uint32))
    n_inv = len(getattr(model, "invocations", []))

    def step():
        loss, _ = model.train_loss({"tokens": tokens})
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in flatten(model.param_tree(), "param").items()}
        model.zero_grad(set_to_none=True)
        return float(loss), grads

    before = (ssd.launches, ssd.bwd_launches, fa.launches, fa.bwd_launches)
    runs = [step(), step()]
    mult = 2 if cfg.remat else 1
    assert (ssd.launches, ssd.bwd_launches, fa.launches, fa.bwd_launches) == (
        before[0] + 2 * mult * cfg.n_layers, before[1] + 2 * cfg.n_layers,
        before[2] + 2 * n_inv, before[3] + 2 * n_inv)
    kept = ssd.ssd_scan_bwd
    ssd.ssd_scan_bwd = lambda *a, **k: ref.ssd_scan_bwd_ref(*a, **k)
    try:
        plain = step()
    finally:
        ssd.ssd_scan_bwd = kept
    assert runs[0][0] == runs[1][0] == plain[0]
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name
        w = plain[1][name]
        assert g.any(), name
        tol = 1e-4 * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=tol, msg=name)


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
