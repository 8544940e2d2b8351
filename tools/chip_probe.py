#!/usr/bin/env python3
"""Diagnostics of the port's kernels on one NVIDIA H100, beside ``chip_smoke.py``.

    python3 tools/chip_probe.py    # from the repository root; needs one CUDA card

1. ``dequant_u8`` at the main path's shapes: the kernel as shipped (groups of
   16 / out_bytes codes, one 16-byte store a thread) against the same kernel
   with groups of 16 codes (one 16-byte load a thread, then 2 or 4 stores 32 or
   64 bytes apart across a warp), both held bit-equal to the plain version;
   then ``%globaltimer`` stamps of the CIFAR batch's blocks (start, scales
   loaded, first group stored, end; ``tools/chip_probe_dequant.cu``).
2. ``decode_attention`` at gemma3-12b's head width 256 (batch 1 to 4, kv
   2,080 rows) and at InternLM2's serving shape: device time at each cluster
   size, beside the cluster ``decode_attention.geometry`` picks.

Times are ``chip_smoke.py``'s profiler mean of 25 calls with L2 flushed. Prints
one JSON object a line, the card's name and power limit first; exits non-zero
without a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (the timing helpers)


def _probe_lib(_build):
    src = ROOT / "tools" / "chip_probe_dequant.cu"
    out = _build.BUILD_DIR / "chip_probe_dequant.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.chip_probe_dequant.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def probe_dequant(torch, lib, flush, dev, sms):
    from repro_torch.kernels import dequant_u8, ref

    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, dtype in (((512, 32, 32, 3), torch.float32), ((256, 224, 224, 3), torch.float32),
                         ((256, 224, 224, 3), torch.bfloat16), ((4096, 4096), torch.bfloat16),
                         ((24, 8192, 2048), torch.float32)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
        C = shape[-1]
        s = torch.rand(C, device=dev, generator=gen) * 0.02 + 1e-3
        b = torch.randn(C, device=dev, generator=gen)
        out = torch.empty(shape, dtype=dtype, device=dev)
        kind = dequant_u8.OUT_KINDS[dtype]
        blocks, stride = dequant_u8.geometry(x.numel(), C, 16, sms)

        def sixteen():
            err = lib.chip_probe_dequant(x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
                                         x.numel(), C, kind, 0, blocks, stride, None, stream)
            if err:
                raise SystemExit(f"chip_probe: launch failed, cudaError_t {err}")

        sixteen()
        exact = bool(torch.equal(out, ref.dequant_u8_ref(x, s, b, dtype)))
        row = {"probe": "dequant_u8", "shape": list(shape), "out_dtype": str(dtype)[6:],
               "ms": chip_smoke._device_ms(
                   torch, lambda: dequant_u8.dequant_u8_fwd(x, s, b, out_dtype=dtype), flush),
               "sixteen_codes_a_thread_ms": chip_smoke._device_ms(torch, sixteen, flush),
               "sixteen_codes_a_thread_exact": exact}
        print(json.dumps(row), flush=True)
        del x, out
        torch.cuda.empty_cache()

    # stamps of the CIFAR batch's blocks, microseconds from the first block's start
    x = torch.randint(0, 256, (512, 32, 32, 3), dtype=torch.uint8, device=dev, generator=gen)
    s = torch.rand(3, device=dev, generator=gen) * 0.02 + 1e-3
    b = torch.randn(3, device=dev, generator=gen)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    blocks, stride = dequant_u8.geometry(x.numel(), 3, 4, sms)
    stamps = torch.zeros((blocks, 4), dtype=torch.int64, device=dev)
    for rep in range(5):
        flush.zero_()
        err = lib.chip_probe_dequant(x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     x.numel(), 3, 0, 1, blocks, stride, stamps.data_ptr(), stream)
        torch.cuda.synchronize()
        if err or not torch.equal(out, ref.dequant_u8_ref(x, s, b, torch.float32)):
            raise SystemExit("chip_probe: the stamped kernel failed or differs")
        t = (stamps - stamps[:, 0].min()).double() / 1e3
        print(json.dumps({"probe": "dequant_u8_stamps", "shape": [512, 32, 32, 3],
                          "rep": rep, "blocks": blocks,
                          "start_spread_us": float(t[:, 0].max()),
                          "scales_loaded_us": float((t[:, 1] - t[:, 0]).mean()),
                          "first_store_after_us": float((t[:, 2] - t[:, 1]).mean()),
                          "block_life_us": float((t[:, 3] - t[:, 0]).mean()),
                          "last_end_us": float(t[:, 3].max())}), flush=True)


def probe_decode_clusters(torch, flush, dev, sms):
    from repro_torch.kernels import _build, decode_attention

    gen = torch.Generator(device=dev).manual_seed(0)
    fn = _build.function("decode_attention.cu", "decode_attention_launch",
                         decode_attention._ARGTYPES)
    for B, KV, g, S, hd, window in ((1, 8, 2, 2080, 256, 0), (2, 8, 2, 2080, 256, 0),
                                    (3, 8, 2, 2080, 256, 0), (4, 8, 2, 2080, 256, 0),
                                    (4, 8, 2, 2080, 256, 1024), (8, 8, 2, 576, 128, 0)):
        q = torch.randn((B, KV, g, hd), device=dev, generator=gen).bfloat16()
        k, v = (torch.randn((B, KV, S, hd), device=dev, generator=gen).bfloat16()
                for _ in range(2))
        o = torch.empty_like(q)
        pos = torch.full((1,), S - 1, dtype=torch.int32, device=dev)
        ms = {}
        for cluster in decode_attention.CLUSTER_SIZES:
            def run(cluster=cluster):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), o.data_ptr(),
                         B, KV, g, S, hd, 2, window, hd ** -0.5, cluster, -(-S // cluster),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"chip_probe: decode launch failed, cudaError_t {err}")
            ms[cluster] = chip_smoke._device_ms(torch, run, flush, events=1)
        print(json.dumps({"probe": "decode_attention_clusters", "B": B, "KV": KV, "g": g,
                          "S": S, "hd": hd, "window": window, "pos": S - 1,
                          "geometry": decode_attention.geometry(B, KV, g, S, sms),
                          "ms_by_cluster": ms}), flush=True)


def main() -> int:
    import torch

    card = chip_smoke.phase_environment(torch)
    from repro_torch.kernels import _build

    _build.build()
    lib = _probe_lib(_build)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    probe_dequant(torch, lib, flush, dev, sms)
    probe_decode_clusters(torch, flush, dev, sms)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
