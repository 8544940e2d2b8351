"""Tests of the port that need a CUDA card: the hand-written kernel against
its plain PyTorch version, and the device feed on the card against the host
decode. Each skips without a card. This file imports nothing of JAX, so it
runs on a machine that has a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.data import DataLoader, DatasetBuilder, DeviceLoader, RaDataset
from repro_torch.kernels import dequant_u8 as dq
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the dequant kernel has no CPU mode")
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
