#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases (any failure exits non-zero and prints no result):

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: ``nvcc`` compiles every CUDA source of the port into ``build/``;
   then ``cuobjdump -sass`` must show HGMMA (wgmma) and UTMALDG (TMA tile
   loads) in the flash library and in the flash backward library (with
   UBLKCP there too: the LSE and D rows come by bulk copies), UBLKCP (bulk copies) and UCGABAR_ARV /
   UCGABAR_WAIT (the cluster barrier) in the decode library, and HMMA
   (mma.sync) in the SSD library;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it and at edge shapes: ``dequant_u8``
   bit-equal (also at the largest leaf of phase 5's u8 cold start),
   ``flash_attention`` and ``decode_attention`` within the tolerance of
   ``tests/test_kernels.py`` (f32 2e-5, bf16 2e-2), at head width 128
   (InternLM2; Zamba2-1.2B's shared block, phase 11: q/k/v (8,32,256,128)
   and its decode, group 1, over 288 rows), 256 (gemma3-12b, phase 7) and
   at the training forwards (InternLM2's, paper_lm's q/k/v (8,4,256,64)
   f32, phase 8, and gemma3's q (2,16,2048,256) bf16, global and window
   1024, phase 10); at the
   main-path shapes the device time of the kernel, of the plain version and
   of one library call computing the same function (profiler trace of 25
   calls, L2 flushed before each; a ``decode_attention`` call must show
   exactly one device event), and the kernel's time between two CUDA
   events (median of 25, launch overhead included), beside the least time
   the card could take (the larger of bytes over the data-sheet 3.35 TB/s
   and operations over 989 TFLOP/s bf16 or 67 TFLOP/s f32);
4. the device feed: a CIFAR-10-shaped RawArray dataset (50,000 × 32×32×3,
   uint8 codes on disk) for one full epoch at batch 512, then 8 batches of
   an ImageNet-shaped one (2,048 × 224×224×3, batch 256), every batch held
   against the host decode of the same batch;
5. serving: InternLM2-1.8B at its full widths and depth (24 layers, bf16,
   random weights from seed 0 on the card, the attention projections scaled
   to their true fan-in: see ``_temper_attention``) saved as a RawArray checkpoint,
   raw and ``quantize="u8"``; both restored by the cold start (raw leaves
   bit-equal to the saved ones, u8 leaves bit-equal to the plain decode of
   their codes, one ``dequant_u8`` launch per float leaf); then
   ``ServeEngine(checkpoint=raw)`` answers 8 prompts of 512 tokens with 64
   new tokens each (24 ``flash_attention`` and 24 × 64 ``decode_attention``
   launches, all 24 flash launches on the tensor-core kernel), warm again,
   then one request with a 4,096-token prompt (``long_prefill_s``, 24
   tensor-core flash launches), and the 8 requests again with the two
   attention ops swapped for their plain versions: first-step logits within
   a bf16 tolerance, greedy-token agreement reported. The u8 checkpoint is of an
   f32 copy of the weights (a training checkpoint's dtype), since bf16
   leaves are stored verbatim under ``quantize="u8"``;
3c. (run with phase 3) ``ssd_scan`` against its plain version on the card:
   the serving shape, Zamba2-1.2B's prefill (x (8,64,256,64), N 64), a
   long prompt, the JAX sweep's f32 shapes, a chunk of 100, a single chunk
   and a slow decay that keeps the state alive across every chunk; y and
   the final state within their tolerances;
6. serving: Mamba2-780M at its full widths and depth (48 layers, bf16,
   random weights from seed 0 on the card) saved as a raw RawArray
   checkpoint and restored through ``ServeEngine(checkpoint=raw)`` (leaves
   bit-equal); 8 prompts of 512 tokens with 64 new tokens each (48
   ``ssd_scan`` launches, all 48 on the tensor-core kernels, no attention
   launch), warm again, and again with
   the scan swapped for its plain version: first-step logits within a bf16
   tolerance, greedy-token agreement reported;
3d. (run with phase 3) the backward of ``flash_attention``
   (``csrc/flash_attention_bwd.cu``: f32 on the SIMT pipes, bf16 on the
   tensor cores by ``wgmma`` fed by a TMA ring) against its plain version
   on the card: paper_lm's training shape (q/k/v (8,4,256,64) f32, causal),
   InternLM2's (q (4,16,2048,128), k/v (4,8,2048,128) bf16, causal),
   gemma3-12b's (q (2,16,2048,256), k/v (2,8,2048,256) bf16, causal, its
   local layers' window 1024 and its global layers) and edges (a ragged S,
   window 1024, hd 32, hd 256, 64-row tiles, groups of 1, 2, 4 and 8); dq,
   dk, dv within f32 1e-4 / bf16 2e-2 of each one's largest entry, two
   calls bit-equal; at the training shapes the device time, the plain
   version's, and the backward of ``scaled_dot_product_attention`` (K/V
   repeated over the group, a boolean mask for the window; timed only),
   beside the bound (bytes over 3.35 TB/s, or 2.5 × the masked forward's
   operations over 989 TFLOP/s bf16 or 67 TFLOP/s f32);
7. serving: gemma3-12b at its full widths (d_model 3840, 16 heads / 8 KV of
   head width 256, GeGLU 15360, vocab 262,144, QK-norm, sandwich norms, 5
   local layers of window 1024 to 1 global), its depth cut from 48 to 12
   layers (two periods of the pattern), bf16, random weights from seed 0 on
   the card with the attention projections tempered as InternLM2's, saved as
   a raw RawArray checkpoint and restored through
   ``ServeEngine(checkpoint=raw)`` (leaves bit-equal); 4 prompts of 2,048
   tokens (numpy seed 2, longer than the window) with 32 new tokens each (12
   ``flash_attention`` launches, all on the tensor-core kernel, and 12 × 32
   ``decode_attention`` launches, one device event per layer in a traced
   step), warm again, and again with plain attention: first-step logits
   within a bf16 tolerance, greedy-token agreement reported;
8. training: paper_lm at its published size (4 layers, d_model 256, vocab
   4,096, f32) through the port's CLI (``repro_torch.launch.train.run``),
   with ``--device-feed --batch 8`` on a RawArray token dataset (seq 256,
   seed 0): 60 steps straight, then 40 steps and a resume to 60 from the
   step-40 checkpoint (it must print ``[train] resumed from step 40``); the
   loss falls, the two runs' parameters agree (rtol 1e-5, atol 1e-6;
   bit-equality reported), each run launches the flash forward and
   backward kernels once a layer a step; then ``ServeEngine`` restores the
   trained checkpoint and answers 2 prompts of 64 tokens with 16 greedy
   tokens, equal to a run with plain attention; one more step of a fresh
   model under the profiler (forward and backward, then the optimizer):
   device time by kind and the idle share;
9. training: InternLM2-1.8B at its full widths and depth (24 layers, bf16,
   remat), random weights from seed 0 with the attention tempered as in
   phase 5, a RawArray token dataset of 64 × 2,048 tokens at vocab 92,544
   (numpy seed 3) fed by ``DeviceLoader``, batch 4 × 2,048: the first step's
   loss and global gradient norm against a first step with plain attention
   (within 1% and 2%), and each layer's wq/wk/wv/wo gradient against plain
   attention's (relative error within ``ATTN_GRAD_TOL``; two planted
   backward faults, dk zeroed and dq 10% too large, must exceed it), then ``train()`` for 6 steps with f32 AdamW moments,
   a checkpoint at step 6 (params and optimizer state, 18.9 GB) restored
   by ``restore_pipelined`` bit-equal, launch counts 24 × 6 × 2 forward
   (remat runs each layer's forward twice) and 24 × 6 backward; then one
   more step under the profiler, as in phase 8;
10. training: gemma3-12b at its full widths (phase 7's model, head width
   256, 5 local layers of window 1024 to 1 global, remat) and 12 of 48
   layers, random weights from seed 0 tempered as in phase 5, a RawArray
   token dataset of 16 × 2,048 tokens at vocab 262,144 (numpy seed 4),
   batch 2 × 2,048 (past the window, so the local and the global backward
   both run): the first step's gates of phase 9, then 4 steps of the train
   loop's step (``train.loop.make_step``, on ``DeviceLoader`` batches; no
   checkpoint: ``train()`` would save 37 GB at its end, and phases 8 and 9
   hold that path) with the loss falling, launch counts 12 × 4 × 2 forward
   and 12 × 4 backward, peak device memory; then one more step under the
   profiler, as in phase 8. In a profiled step the attention kernels are
   found by the ``__global__`` functions of their sources;
11. serving: Zamba2-1.2B at its full size (38 Mamba2 layers, d_model 2048,
   one shared attention+MLP block, 32 heads of 128 over ``concat([x, x0])``,
   invoked 6 times; bf16, 1.2 B parameters, nothing cut), random weights from
   seed 0 with the shared attention tempered as in phase 5, saved as a raw
   RawArray checkpoint and restored through ``ServeEngine(checkpoint=raw)``
   (leaves bit-equal); 8 prompts of 256 tokens (numpy seed 3) with 32 new
   tokens each, served through the engine's prompt replay (6 × 287
   ``decode_attention`` launches and nothing else), warm again (ms per
   replayed token), and again with attention and scan plain: first-step
   logits within a bf16 tolerance, greedy-token agreement reported; then
   ``model.prefill`` (6 flash and 38 ``ssd_scan`` launches, all on the
   tensor cores) within the same tolerance of its plain version, and an f32
   copy's prefill against its replay (rtol 2e-3, atol 2e-4 of the logits'
   scale, ``tests/test_models.py:63-78``).

The last three lines are the card's name and power limit, one JSON object
listing each kernel, and the result ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # H100 SXM data sheet, dense bf16 tensor cores
F32_FLOPS = 67e12          # H100 SXM data sheet, f32 outside the tensor cores
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of each gradient's largest |entry|
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:19
# ssd_scan: f32 as tests/test_kernels.py:79 (rtol 1e-3, atol 1e-4); bf16 2e-2 of the
# output's scale (kernel and plain version both compute in f32 and differ in the
# order of their sums; y is rounded once to bf16, 2**-8 relative); the f32 final
# state 1e-3 of its scale (sums over up to 4,096 steps in another order)
SSD_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (0.0, 2e-2)}
SSD_STATE_TOL = 1e-3
LOGITS_TOL = 5e-2  # of max |plain logits|: bf16 activations through 24 layers
REPS = 25
SEED = 0


def log(*args) -> None:
    print(*args, flush=True)


# --------------------------------------------------------------- phase 1
def phase_environment(torch) -> str:
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] torch sees {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    return card


# --------------------------------------------------------------- phase 2
def phase_build() -> float:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    for source, text in logs.items():
        log(f"[build] nvcc {source}:\n{text.strip()}")
    log(f"[build] {len(logs)} source(s) compiled, {len(_build.SOURCES) - len(logs)} "
        f"already built, {seconds:.3f} s")
    return seconds


def phase_sass() -> dict:
    """Count, in each built library, the instructions its design rests on:
    the bf16 flash kernel runs on the tensor cores (HGMMA, wgmma) fed by TMA
    (UTMALDG); so does the bf16 flash backward, whose dK/dV kernel also
    brings each tile's LSE and D rows by bulk copies (UBLKCP); the decode kernel streams K/V by bulk
    copies (UBLKCP) and folds its splits across a cluster (UCGABAR_ARV /
    UCGABAR_WAIT, the cluster barrier); the bf16 SSD scan runs its products
    on the tensor cores (HMMA, mma.sync). Any count of 0 fails."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    wanted = {
        "flash_attention.cu": ("HGMMA", "UTMALDG"),
        "flash_attention_bwd.cu": ("HGMMA", "UTMALDG", "UBLKCP"),
        "decode_attention.cu": ("UBLKCP", "UCGABAR_ARV", "UCGABAR_WAIT"),
        "ssd_scan.cu": ("HMMA",),
    }
    counts = {}
    for source, ops in wanted.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.lib_path(source))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts[source] = {op: sass.count(op) for op in ops}
    log(f"[sass] {json.dumps(counts)}")
    missing = {src: c for src, c in counts.items() if not all(c.values())}
    if missing:
        raise SystemExit(f"chip_smoke: instructions missing from the SASS: {missing}")
    return counts


# --------------------------------------------------------------- phase 3
def _event_ms(torch, fn, flush) -> float:
    """Median over REPS of one call between two CUDA events, L2 flushed
    before each. Includes any gap while the host issues the call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()  # cold L2; also keeps the card busy while the call is issued
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(torch, fn, flush, attempts: int = 3, events: int | None = None) -> float:
    """Device time of one call: the summed durations of the kernels it ran,
    from a profiler trace of REPS calls (L2 flushed before each; the flush's
    own fill kernels are left out), divided by REPS. Host launch overhead
    and gaps between a call's kernels are not in it. A trace whose event
    count is not a multiple of REPS (a library call, cuDNN's masked SDPA,
    has shown one now and then) is taken again, up to ``attempts`` times.
    With ``events``, a trace must show exactly that many device events per
    call, or the run fails."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        names = Counter()
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "FillFunctor" in evt.name or evt.name == "Activity Buffer Request":
                continue
            total_us += evt.time_range.elapsed_us()
            names[evt.name[:120]] += 1
        count = sum(names.values())
        if events is not None and count != events * REPS:
            raise SystemExit(f"chip_smoke: {count} device events in {REPS} calls, wanted "
                             f"{events} per call: {dict(names)}")
        if count and count % REPS == 0:
            return total_us / REPS / 1e3
        log(f"[kernels] the profiler saw {count} device events in {REPS} calls: "
            f"{dict(names)}")
    raise SystemExit(f"chip_smoke: {attempts} profiler traces of {REPS} calls each "
                     f"saw a number of device events that is not a multiple of {REPS}")


def _largest_leaf(torch) -> tuple:
    """Shape of the largest float leaf that phase 5's u8 cold start decodes
    (InternLM2-1.8B; the checkpoint is of an f32 copy, so it decodes to f32)."""
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    leaves = flatten(build_model(get_config("internlm2_1_8b"), device="meta").param_tree(),
                     "param").values()
    return tuple(max(leaves, key=lambda t: t.numel()).shape)


def phase_kernels(torch) -> list:
    from repro_torch.kernels import dequant_u8, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MiB > 50 MB L2

    def inputs(shape, offset=0):
        C = shape[-1]
        n = 1
        for d in shape:
            n *= d
        buf = torch.randint(0, 256, (n + offset,), dtype=torch.uint8, device=dev, generator=gen)
        x = buf[offset:].view(shape)
        scale = torch.rand(C, device=dev, generator=gen) * 0.02 + 1e-3
        bias = torch.randn(C, device=dev, generator=gen)
        return x, scale, bias

    # (label, shape, out dtype, timed, pointer offset); timed = a main-path shape
    cases = [
        ("cifar_batch", (512, 32, 32, 3), torch.float32, True, 0),
        ("imagenet_batch", (256, 224, 224, 3), torch.float32, True, 0),
        ("imagenet_batch", (256, 224, 224, 3), torch.bfloat16, True, 0),
        ("checkpoint_leaf", (4096, 4096), torch.bfloat16, True, 0),
        ("u8_cold_start_largest_leaf", _largest_leaf(torch), torch.float32, True, 0),
        ("edge", (1, 1), torch.float32, False, 0),
        ("edge", (1000, 130), torch.float32, False, 0),
        ("edge", (1000, 130), torch.bfloat16, False, 0),
        ("edge", (1000, 130), torch.float16, False, 0),
        ("edge", (1000, 130), torch.float64, False, 0),
        ("edge_misaligned", (1000, 130), torch.float32, False, 1),
        ("edge_misaligned", (999, 3), torch.bfloat16, False, 3),
    ]
    rows = []
    for label, shape, out_dtype, timed, offset in cases:
        x, scale, bias = inputs(shape, offset)
        out = dequant_u8.dequant_u8_fwd(x, scale, bias, out_dtype=out_dtype)
        torch.cuda.synchronize()
        plain = ref.dequant_u8_ref(x, scale, bias, out_dtype)
        exact = bool(torch.equal(out, plain))
        err = float((out.double() - plain.double()).abs().max()) if out.numel() else 0.0
        E, blocks, stride = dequant_u8.launch_plan(x, out)
        row = {
            "case": label, "shape": list(shape), "out_dtype": str(out_dtype).split(".")[-1],
            "data_ptr_mod_16": int(x.data_ptr() % 16), "exact": exact, "max_abs_err": err,
            "codes_per_group": E, "blocks": blocks, "stride_groups": stride,
        }
        if timed:
            n = x.numel()
            out_bytes = torch.empty(0, dtype=out_dtype).element_size()
            lib_scale, lib_bias = scale.to(out_dtype), bias.to(out_dtype)
            kernel = lambda: dequant_u8.dequant_u8_fwd(x, scale, bias, out_dtype=out_dtype)
            plain_fn = lambda: ref.dequant_u8_ref(x, scale, bias, out_dtype)
            library = lambda: torch.addcmul(lib_bias, x, lib_scale)
            row.update(
                ms=_device_ms(torch, kernel, flush),
                plain_ms=_device_ms(torch, plain_fn, flush),
                library_ms=_device_ms(torch, library, flush),
                event_ms=_event_ms(torch, kernel, flush),
                bound_ms=(n + n * out_bytes) / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes",
            )
        log(f"[kernels] dequant_u8 {json.dumps(row)}")
        rows.append(row)
        if not exact:
            raise SystemExit(f"chip_smoke: dequant_u8 differs from its plain version: {row}")
        del x, out, plain
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 3b
def _live_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention mask keeps: the work this input needs."""
    import numpy as np

    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= k <= q
    if window > 0:
        ok &= k > q - window
    return int(ok.sum())


def _bound(nbytes: int, flops: int, peak: float = BF16_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _timings(torch, kernel, plain, library, flush, nbytes, flops, events=None,
             peak: float = BF16_FLOPS) -> dict:
    """Device ms of the kernel (``events``: the device events each call must
    show), its plain version and the library call (None where no single
    library call computes the function), event ms, bound (operations over
    ``peak``)."""
    bound_ms, bound_by = _bound(nbytes, flops, peak)
    return {
        "ms": _device_ms(torch, kernel, flush, events=events),
        "plain_ms": _device_ms(torch, plain, flush),
        "library_ms": _device_ms(torch, library, flush) if library is not None else None,
        "event_ms": _event_ms(torch, kernel, flush),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
    }


def _check_close(torch, name, row, out, plain):
    tol = ATTN_TOL[row["dtype"]]
    row["max_abs_err"] = float((out.float() - plain.float()).abs().max()) if out.numel() else 0.0
    row["tolerance"] = tol
    ok = bool(torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol))
    log(f"[kernels] {name} {json.dumps(row)}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} differs from its plain version: {row}")


def phase_attention(torch) -> tuple:
    """Both attention kernels against their plain versions on the card."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, ops, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtypes[dtype])

    # (label, B, H, KV, Sq, Sk, hd, dtype, causal, window, timed)
    flash_cases = [
        ("prefill", 8, 16, 8, 576, 576, 128, "bfloat16", True, 0, True),
        ("long_prefill", 1, 16, 8, 4096, 4096, 128, "bfloat16", True, 0, True),
        # InternLM2's training forward (phase 9): 4 sequences of 2,048 tokens
        ("internlm2_train", 4, 16, 8, 2048, 2048, 128, "bfloat16", True, 0, True),
        # paper_lm's training forward (phase 8): 8 sequences of 256 tokens, f32
        ("paper_lm_train", 8, 4, 4, 256, 256, 64, "float32", True, 0, True),
        ("edge_one_row", 1, 16, 8, 1, 1, 128, "bfloat16", True, 0, False),
        ("edge_tail_tile_bf16", 2, 16, 8, 130, 130, 128, "bfloat16", True, 0, False),
        ("edge_sk_gt_sq", 2, 16, 8, 96, 160, 128, "bfloat16", True, 0, False),
        ("edge_tail_tile", 2, 4, 2, 130, 130, 64, "float32", True, 0, False),
        ("edge_window_64", 2, 16, 8, 576, 576, 128, "bfloat16", True, 64, False),
        ("edge_hd64", 2, 8, 8, 200, 200, 64, "float32", True, 0, False),
        ("edge_hd32", 2, 4, 2, 100, 100, 32, "bfloat16", True, 0, False),
        ("edge_g1", 2, 4, 4, 256, 256, 64, "bfloat16", False, 0, False),
        ("edge_f32", 2, 16, 8, 576, 576, 128, "float32", True, 0, False),
        # gemma3-12b (phase 7): its prefill, 4 prompts padded to 2,048 + 32 rows,
        # on a global layer and on a local one (window 1024)
        ("gemma3_prefill", 4, 16, 8, 2080, 2080, 256, "bfloat16", True, 0, True),
        ("gemma3_prefill_local", 4, 16, 8, 2080, 2080, 256, "bfloat16", True, 1024, True),
        # gemma3-12b's training forward (phase 10): 2 sequences of 2,048 tokens, on
        # a global layer and on a local one
        ("gemma3_train", 2, 16, 8, 2048, 2048, 256, "bfloat16", True, 0, True),
        ("gemma3_train_local", 2, 16, 8, 2048, 2048, 256, "bfloat16", True, 1024, True),
        ("edge_hd256_f32", 2, 4, 2, 300, 300, 256, "float32", True, 64, False),
        ("edge_hd256_tail_tile", 2, 16, 8, 130, 130, 256, "bfloat16", True, 0, False),
        ("edge_hd256_sk_gt_sq", 2, 16, 8, 96, 160, 256, "bfloat16", True, 0, False),
        ("edge_hd256_g1", 2, 4, 4, 256, 256, 256, "bfloat16", False, 0, False),
        # Zamba2-1.2B's model.prefill (phase 11): the shared block's MHA over
        # concat([x, x0]), 32 heads of 128, 8 prompts of 256 tokens
        ("zamba2_prefill", 8, 32, 32, 256, 256, 128, "bfloat16", True, 0, True),
    ]
    flash_rows = []
    for label, B, H, KV, Sq, Sk, hd, dt, causal, window, timed in flash_cases:
        q, k, v = randn((B, H, Sq, hd), dt), randn((B, KV, Sk, hd), dt), randn((B, KV, Sk, hd), dt)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        row = {"case": label, "shape": {"q": [B, H, Sq, hd], "kv": [B, KV, Sk, hd]},
               "dtype": dt, "causal": causal, "window": window}
        if timed:
            esize = q.element_size()
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * esize
            flops = 4 * hd * B * H * _live_pairs(Sq, Sk, causal, window)
            if window:  # the same function in one library call: a boolean mask
                qp, kp = torch.arange(Sq, device=dev)[:, None], torch.arange(Sk, device=dev)
                keep = (kp <= qp) & (kp > qp - window)
                library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                                 enable_gqa=True)
            else:
                library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 enable_gqa=True)
            row.update(_timings(
                torch,
                lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
                lambda: ref.flash_attention_ref(q, k, v, causal=causal, window=window),
                library, flush, nbytes, flops,
                peak=BF16_FLOPS if dt == "bfloat16" else F32_FLOPS,
            ))
            row["peak_flops"] = BF16_FLOPS if dt == "bfloat16" else F32_FLOPS
        _check_close(torch, "flash_attention", row, out, plain)
        flash_rows.append(row)

    # (label, B, KV, g, S, hd, pos, dtype, window, garbage past pos, timed)
    decode_cases = [
        ("decode", 8, 8, 2, 576, 128, 575, "bfloat16", 0, False, True),
        ("long_decode", 8, 8, 2, 4096, 128, 4095, "bfloat16", 0, False, True),
        ("edge_pos0", 8, 8, 2, 576, 128, 0, "bfloat16", 0, True, False),
        ("edge_garbage_past_pos", 8, 8, 2, 576, 128, 300, "bfloat16", 0, True, False),
        ("edge_window_64", 2, 8, 2, 576, 128, 400, "bfloat16", 64, True, False),
        ("edge_hd64", 2, 4, 4, 256, 64, 100, "float32", 0, True, False),
        ("edge_hd32", 2, 2, 8, 128, 32, 127, "float32", 0, False, False),
        ("edge_g1", 2, 8, 1, 576, 128, 575, "bfloat16", 0, False, False),
        ("edge_one_row", 1, 8, 2, 1, 128, 0, "bfloat16", 0, False, False),
        ("edge_g6", 2, 2, 6, 300, 128, 299, "float32", 0, False, False),
        ("edge_pos_cta_boundary", 8, 8, 2, 576, 128, 288, "bfloat16", 0, True, False),
        ("edge_window_across_ctas", 2, 8, 2, 576, 128, 300, "bfloat16", 100, True, False),
        # gemma3-12b (phase 7): its decode at the last step's pos, global and local
        ("gemma3_decode", 4, 8, 2, 2080, 256, 2079, "bfloat16", 0, False, True),
        ("gemma3_decode_local", 4, 8, 2, 2080, 256, 2079, "bfloat16", 1024, False, True),
        ("edge_hd256_f32", 4, 8, 2, 2080, 256, 2079, "float32", 0, True, False),
        ("edge_hd256_g1", 1, 8, 1, 576, 256, 300, "bfloat16", 0, True, False),
        ("edge_hd256_g8", 1, 2, 8, 576, 256, 575, "bfloat16", 100, False, False),
        ("edge_hd256_window_across_ctas", 2, 8, 2, 2080, 256, 1500, "bfloat16", 1024, True,
         False),
        # Zamba2-1.2B (phase 11): the shared block's decode at the last step's pos
        # (256 + 32 rows, group 1)
        ("zamba2_decode", 8, 32, 1, 288, 128, 287, "bfloat16", 0, False, True),
    ]
    decode_rows = []
    for label, B, KV, g, S, hd, pos, dt, window, garbage, timed in decode_cases:
        q = randn((B, KV * g, hd), dt)
        k, v = randn((B, KV, S, hd), dt), randn((B, KV, S, hd), dt)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = ops.decode_attention(q, k, v, p, window=window)
        torch.cuda.synchronize()
        plain = ref.decode_attention_ref(q.reshape(B, KV, g, hd), k, v, p,
                                         window=window).reshape(B, KV * g, hd)
        cluster, keys = decode_attention.geometry(
            B, KV, g, S, torch.cuda.get_device_properties(dev).multi_processor_count)
        row = {"case": label, "shape": {"q": [B, KV * g, hd], "kv": [B, KV, S, hd]},
               "dtype": dt, "pos": pos, "window": window, "cluster": cluster,
               "keys_per_cta": keys}
        if garbage:  # rows past pos are never read: NaN there changes nothing
            k2, v2 = k.clone(), v.clone()
            k2[:, :, pos + 1:] = float("nan")
            v2[:, :, pos + 1:] = 1e30
            again = ops.decode_attention(q, k2, v2, p, window=window)
            torch.cuda.synchronize()
            row["garbage_past_pos_equal"] = bool(torch.equal(again, out))
            if not row["garbage_past_pos_equal"]:
                raise SystemExit(f"chip_smoke: decode_attention read rows past pos: {row}")
        if timed:
            lo = max(0, pos - window + 1) if window else 0
            live = pos - lo + 1
            esize = q.element_size()
            nbytes = (2 * q.numel() + 2 * B * KV * live * hd) * esize
            flops = 4 * hd * B * KV * g * live
            kpos = torch.arange(S, device=dev)
            mask = (kpos <= p) & (kpos > p - window) if window else kpos <= p
            mask = mask.view(1, 1, 1, S)
            q4 = q.view(B, KV * g, 1, hd)
            row.update(_timings(
                torch,
                lambda: ops.decode_attention(q, k, v, p, window=window),
                lambda: ref.decode_attention_ref(q.reshape(B, KV, g, hd), k, v, p, window=window),
                lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True),
                flush, nbytes, flops, events=1,
            ))
        _check_close(torch, "decode_attention", row, out, plain)
        decode_rows.append(row)
    return flash_rows, decode_rows


# --------------------------------------------------------------- phase 3c
def phase_ssd(torch) -> list:
    """``ssd_scan`` against its plain version on the card."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # (label, B, H, L, P, N, chunk, dtype, dtA range, timed). dtA at the model's
    # scales (dt about 0.7, A in [-16, -1]) decays the state to nothing within a
    # chunk; the slow-decay rows keep every chunk's state alive to the end.
    model_decay, slow = (0.5, 8.0), (0.0, 0.01)
    cases = [
        ("serving", 8, 48, 512, 64, 128, 128, "bfloat16", model_decay, True),
        ("long_prompt", 1, 48, 4096, 64, 128, 128, "bfloat16", model_decay, True),
        ("edge_jax_sweep", 1, 2, 128, 32, 16, 32, "float32", (0.0, 0.3), False),
        ("edge_jax_sweep", 2, 3, 256, 64, 32, 64, "float32", (0.0, 0.3), False),
        ("edge_jax_sweep_one_chunk", 1, 1, 64, 16, 8, 64, "float32", (0.0, 0.3), False),
        ("edge_q100", 2, 48, 100, 64, 128, 128, "bfloat16", model_decay, False),
        ("edge_single_chunk", 2, 48, 128, 64, 128, 128, "bfloat16", model_decay, False),
        ("edge_slow_decay", 2, 48, 512, 64, 128, 128, "bfloat16", slow, False),
        ("edge_slow_decay_f32", 1, 4, 4096, 64, 128, 128, "float32", slow, False),
        ("edge_zamba2_widths", 2, 64, 256, 64, 64, 128, "bfloat16", model_decay, False),
        # Zamba2-1.2B's model.prefill (phase 11): 8 prompts of 256 tokens
        ("zamba2_prefill", 8, 64, 256, 64, 64, 128, "bfloat16", model_decay, True),
    ]
    rows = []
    for label, B, H, L, P, N, chunk, dt, (lo, hi), timed in cases:
        def randn(*shape):
            return (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dtypes[dt])

        x, Bm, Cm = randn(B, H, L, P), randn(B, L, N), randn(B, L, N)
        dtA = -(lo + (hi - lo) * torch.rand((B, H, L), generator=gen, device=dev))
        Q = min(chunk, L)
        y, state = ops.ssd_scan(x, dtA, Bm, Cm, chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        want, want_state = ref.ssd_scan_ref(x, dtA, Bm, Cm, chunk=Q)
        rtol, atol = SSD_TOL[dt]
        if dt == "bfloat16":
            atol *= float(want.float().abs().max())
        state_tol = SSD_STATE_TOL * max(1.0, float(want_state.abs().max()))
        row = {"case": label, "shape": {"x": [B, H, L, P], "BC": [B, L, N]}, "chunk": Q,
               "n_chunks": L // Q, "dtype": dt, "dtA": [-hi, -lo],
               "max_abs_err": float((y.float() - want.float()).abs().max()),
               "tolerance": {"rtol": rtol, "atol": atol},
               "state_max_abs_err": float((state - want_state).abs().max()),
               "state_tolerance": {"rtol": SSD_STATE_TOL, "atol": state_tol}}
        ok = bool(torch.allclose(y.float(), want.float(), rtol=rtol, atol=atol)) and \
            bool(torch.allclose(state, want_state, rtol=SSD_STATE_TOL, atol=state_tol))
        if timed:
            esize = x.element_size()
            # x, dtA, B and C read once; y and the f32 final state (the prefill
            # asks for it) written once
            nbytes = 2 * x.numel() * esize + dtA.numel() * 4 + 2 * Bm.numel() * esize \
                + state.numel() * 4
            pairs = Q * (Q + 1) // 2  # (i, j <= i) pairs of a chunk's causal mask
            n_chunks = L // Q
            # C·Bᵀ once per (batch, chunk); per (batch, head, chunk) the masked
            # scores times x, C times the state, and x's decayed outer product with B
            flops = 2 * B * n_chunks * (pairs * N + H * (pairs * P + 2 * Q * P * N))
            row.update(_timings(
                torch,
                lambda: ops.ssd_scan(x, dtA, Bm, Cm, chunk=chunk, return_state=True),
                lambda: ref.ssd_scan_ref(x, dtA, Bm, Cm, chunk=Q),
                None, flush, nbytes, flops,
            ))
        log(f"[kernels] ssd_scan {json.dumps(row)}")
        if not ok:
            raise SystemExit(f"chip_smoke: ssd_scan differs from its plain version: {row}")
        rows.append(row)
    return rows


# --------------------------------------------------------------- phase 3d
def phase_attention_bwd(torch) -> list:
    """The backward of ``flash_attention`` against its plain version on the
    card, at the two training shapes (timed) and at edge shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtypes[dtype])

    # (label, B, H, KV, S, hd, dtype, causal, window, timed)
    cases = [
        ("paper_lm_train", 8, 4, 4, 256, 64, "float32", True, 0, True),
        ("internlm2_train", 4, 16, 8, 2048, 128, "bfloat16", True, 0, True),
        # gemma3-12b's training shapes (phase 10): its local and its global layers
        ("gemma3_train_local", 2, 16, 8, 2048, 256, "bfloat16", True, 1024, True),
        ("gemma3_train_global", 2, 16, 8, 2048, 256, "bfloat16", True, 0, True),
        ("edge_ragged", 2, 16, 8, 300, 128, "bfloat16", True, 0, False),
        ("edge_64_row_tiles", 2, 16, 8, 192, 128, "bfloat16", True, 0, False),
        ("edge_hd256_ragged", 2, 16, 8, 300, 256, "bfloat16", True, 0, False),
        ("edge_hd256_window_ragged", 1, 16, 8, 2100, 256, "bfloat16", True, 1024, False),
        ("edge_hd256_g4", 1, 4, 1, 65, 256, "bfloat16", True, 0, False),
        ("edge_ragged_f32", 2, 4, 2, 300, 64, "float32", True, 0, False),
        ("edge_window_1024", 2, 16, 8, 2048, 128, "bfloat16", True, 1024, False),
        ("edge_hd32", 2, 4, 2, 100, 32, "float32", True, 0, False),
        ("edge_hd32_bf16", 2, 8, 1, 130, 32, "bfloat16", True, 0, False),
        ("edge_g1", 2, 4, 4, 256, 128, "bfloat16", True, 0, False),
        ("edge_g2", 2, 8, 4, 200, 64, "float32", True, 64, False),
        ("edge_g8", 1, 8, 1, 130, 64, "float32", True, 0, False),
        ("edge_f32_hd128_window", 2, 4, 2, 129, 128, "float32", True, 64, False),
        ("edge_noncausal", 1, 4, 4, 200, 64, "float32", False, 0, False),
    ]
    rows = []
    for label, B, H, KV, S, hd, dt, causal, window, timed in cases:
        q, do = randn((B, H, S, hd), dt), randn((B, H, S, hd), dt)
        k, v = randn((B, KV, S, hd), dt), randn((B, KV, S, hd), dt)
        out, lse = flash_attention.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                                       return_lse=True)
        _, plain_lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                               return_lse=True)

        def kernel():
            return flash_attention.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                                       window=window)

        def plain_fn():
            return ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal,
                                               window=window)

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        want = plain_fn()
        tol = BWD_TOL[dt]
        rel = {n: float((g.float() - w.float()).abs().max() / w.float().abs().max())
               for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        row = {"case": label, "shape": {"q": [B, H, S, hd], "kv": [B, KV, S, hd]},
               "dtype": dt, "causal": causal, "window": window,
               "max_abs_err": max(float((g.float() - w.float()).abs().max())
                                  for g, w in zip(got, want)),
               "max_rel_err": rel, "tolerance": tol,
               "lse_max_abs_err": float((lse - plain_lse).abs().max()),
               "bit_equal_repeat": all(bool(torch.equal(a, b)) for a, b in zip(got, again))}
        if timed:
            esize = q.element_size()
            # q, k, v, o, dO and the LSE read once; dq, dk, dv written once
            nbytes = (4 * q.numel() + 4 * k.numel()) * esize + lse.numel() * 4
            flops = int(2.5 * 4 * hd * B * H * _live_pairs(S, S, causal, window))
            g = H // KV
            qs = q.detach().clone().requires_grad_()
            ks = k.repeat_interleave(g, dim=1).requires_grad_()
            vs = v.repeat_interleave(g, dim=1).requires_grad_()
            if window > 0:
                pos = torch.arange(S, device=dev)
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                o_lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
            else:
                o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            library = lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do, retain_graph=True)
            row.update(_timings(torch, kernel, plain_fn, library, flush, nbytes, flops,
                                peak=BF16_FLOPS if dt == "bfloat16" else F32_FLOPS))
            row["peak_flops"] = BF16_FLOPS if dt == "bfloat16" else F32_FLOPS
            del qs, ks, vs, o_lib
        log(f"[kernels] flash_attention_bwd {json.dumps(row)}")
        ok = all(r <= tol for r in rel.values()) and row["bit_equal_repeat"] and \
            row["lse_max_abs_err"] <= 1e-3
        if not ok:
            raise SystemExit(f"chip_smoke: flash_attention_bwd differs from its plain version: "
                             f"{row}")
        rows.append(row)
        del q, k, v, do, out, lse, got, again, want
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 4
def _build_dataset(root: str, n: int, hw: int, seed: int, chunk: int) -> float:
    import numpy as np
    from repro_torch.data import DatasetBuilder

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    b = DatasetBuilder(
        root,
        {"image": ((hw, hw, 3), "float32"), "label": ((), "int32")},
        quantize={"image": ("u8", 0.0, 1.0)},
    )
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        b.append(
            image=rng.random((m, hw, hw, 3), dtype=np.float32),
            label=rng.integers(0, 10, m).astype(np.int32),
        )
    b.finish()
    return time.perf_counter() - t0


def _drive(torch, root: str, batch: int, nbatches: int) -> dict:
    """One run of the device feed: ``nbatches`` batches through the port's
    DeviceLoader with the launch count read just before and just after,
    then every batch held against the host decode of the same batch."""
    import numpy as np
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset
    from repro_torch.kernels import dequant_u8

    feed = DeviceLoader(DataLoader(RaDataset(root), batch, seed=SEED, reuse_buffers=True))
    if feed.device.type != "cuda":
        raise SystemExit(f"chip_smoke: DeviceLoader defaulted to {feed.device}, not the card")
    dequant_u8.launches = 0
    t0 = time.perf_counter()
    got = [next(feed) for _ in range(nbatches)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    feed.stop()  # the feeder runs ahead by at most bufs + 1 batches; stopped here
    launches = dequant_u8.launches
    stats = feed.stats()

    host = DataLoader(RaDataset(root), batch, seed=SEED, dequant=True)
    try:
        for i, db in enumerate(got):
            hb = next(host)
            if hb["_state"].__dict__ != db["_state"].__dict__:
                raise SystemExit(f"chip_smoke: batch {i} state {db['_state']} != {hb['_state']}")
            for f in ("image", "label"):
                if db[f].device.type != "cuda":
                    raise SystemExit(f"chip_smoke: batch {i} {f} is on {db[f].device}")
                if not torch.equal(db[f].cpu(), torch.from_numpy(np.asarray(hb[f]))):
                    raise SystemExit(f"chip_smoke: batch {i} field {f} differs from the host decode")
    finally:
        host.stop()

    moved = int(stats["h2d_batches"])
    per_batch = stats["h2d_bytes"] / stats["h2d_batches"]
    row_bytes = got[0]["image"][0].numel() + 4  # u8 codes + int32 label
    out = {
        "batches": nbatches,
        "batch": batch,
        "consumed": int(stats["device_batches"]),
        "moved": moved,
        "launches": launches,
        "seconds": seconds,
        "batches_per_s": nbatches / seconds,
        "h2d_bytes_per_batch": per_batch,
        "h2d_gb_per_s": stats["h2d_bytes"] / stats["h2d_s"] / 1e9,
        "h2d_s": stats["h2d_s"],
        "device_wait_s": stats["device_wait_s"],
        "loader_produce_s": stats["loader_produce_s"],
    }
    if out["consumed"] != nbatches:
        raise SystemExit(f"chip_smoke: consumed {out['consumed']} batches, wanted {nbatches}")
    # one decode launch per batch the feed moved: the consumed ones plus the
    # few the feeder had moved ahead when it was stopped
    if launches != moved or not nbatches <= moved <= nbatches + feed.bufs + 1:
        raise SystemExit(f"chip_smoke: {launches} launches for {moved} moved batches "
                         f"({nbatches} consumed)")
    if per_batch != batch * row_bytes:
        raise SystemExit(f"chip_smoke: {per_batch} h2d bytes per batch, wanted {batch * row_bytes}")
    return out


def phase_main_path(torch) -> list:
    runs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name, n, hw, batch, nbatches, chunk in (
            ("cifar10_epoch", 50_000, 32, 512, 50_000 // 512, 5_000),
            ("imagenet_8_batches", 2_048, 224, 256, 8, 256),
        ):
            root = os.path.join(tmp, name)
            build_s = _build_dataset(root, n, hw, SEED, chunk)
            run = _drive(torch, root, batch, nbatches)
            run.update(name=name, rows=n, image=[hw, hw, 3], dataset_build_s=build_s)
            log(f"[main path] {json.dumps(run)}")
            runs.append(run)
    return runs


# --------------------------------------------------------------- phase 5
def _temper_attention(torch, model) -> None:
    """Rescale the random attention projections to their contraction fan-in
    (for Zamba2 those of its shared block, which attends over
    ``concat([x, x0])``, 2·d_model wide).

    The JAX package's ``Initializer.fanin`` (which the port's init follows)
    divides by ``shape[-2]``: the head count for ``wq``/``wk``/``wv``
    ``(d, heads, hd)`` and ``hd`` for ``wo`` ``(H, hd, d)``. At InternLM2's
    widths q and k then have a std near 11 and 16, q·k/sqrt(hd) near 180,
    softmax is all but an argmax, and the random 24-layer model is chaotic:
    a 1e-7 difference at layer 0 grows about 20x a layer, so no two attention
    implementations agree on its logits, f32 or bf16. Scaled by
    ``1/sqrt(d_model)`` (``1/sqrt(H*hd)`` for ``wo``) instead, scores have a
    std near 1 and the comparison below is meaningful."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        a, d = model.shared.attn, 2 * cfg.d_model
    else:
        a, d = model.dense_layers.attn, cfg.d_model
    H, KV = cfg.n_heads + cfg.head_pad, cfg.n_kv_heads
    with torch.no_grad():
        a.wq.mul_((H / d) ** 0.5)
        a.wk.mul_((KV / d) ** 0.5)
        a.wv.mul_((KV / d) ** 0.5)
        a.wo.mul_((1 / H) ** 0.5)


def _score_std(torch, model, tokens) -> float:
    """Std of layer 0's attention scores q·k/sqrt(hd) (q head 0 against KV
    head 0) over ``tokens``: how sharp the random model's softmax is."""
    from repro_torch.models.common import rmsnorm

    a = model.dense_layers.attn
    with torch.inference_mode():
        h = rmsnorm(model._embed_inputs(tokens), model.dense_layers.ln_attn.scale[0])[0].float()
        q = h @ a.wq[0, :, 0, :].float()
        k = h @ a.wk[0, :, 0, :].float()
        return float((q @ k.t() / q.shape[-1] ** 0.5).std())


@contextlib.contextmanager
def _plain_attention():
    """The serving path with both attention ops swapped for their plain
    versions, for this script's comparison only."""
    from repro_torch.kernels import ops, ref

    kept = ops.flash_attention, ops.decode_attention

    def flash(q, k, v, *, causal=True, window=0, **_):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

    def decode(q, k, v, pos, *, window=0, **_):
        B, H, hd = q.shape
        KV = k.shape[1]
        out = ref.decode_attention_ref(q.reshape(B, KV, H // KV, hd), k, v, pos, window=window)
        return out.reshape(B, H, hd)

    ops.flash_attention, ops.decode_attention = flash, decode
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = kept


def phase_serving(torch) -> dict:
    """InternLM2-1.8B: checkpoint, cold start, and a batch of requests."""
    import numpy as np

    from repro_torch.checkpoint import ColdStartStats, load_checkpoint, restore_pipelined
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2_1_8b")
    B, S, max_new = 8, 512, 64
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "dtype": cfg.param_dtype, "batch": B, "prompt": S, "max_new": max_new}
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    probe = torch.randint(1, cfg.vocab, (1, 256), device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    out["score_std_at_init_scales"] = _score_std(torch, model, probe)
    _temper_attention(torch, model)
    out["score_std"] = _score_std(torch, model, probe)
    saved = flatten(model.param_tree(), "param")  # the random weights, kept for the checks
    out["params"] = sum(t.numel() for t in saved.values())
    float_leaves = sum(1 for t in saved.values() if t.is_floating_point() and t.dim())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        t0 = time.perf_counter()
        raw = save_checkpoint(os.path.join(tmp, "raw"), 1, model.param_tree())
        out["save_raw_s"] = time.perf_counter() - t0
        # the u8 checkpoint is of an f32 copy (a training checkpoint's dtype):
        # under quantize="u8" bf16 leaves are stored verbatim, as the JAX
        # package stores them, and f32 ones become codes the kernel decodes
        t0 = time.perf_counter()
        f32 = _float32(torch, model.param_tree())
        u8 = save_checkpoint(os.path.join(tmp, "u8"), 1, f32, quantize="u8")
        del f32
        out["save_u8_s"] = time.perf_counter() - t0
        out["u8_checkpoint_of"] = "float32"

        # u8 cold start: codes cross the link, the kernel decodes them on the card
        st = ColdStartStats()
        dequant_u8.launches = 0
        got, _, _ = restore_pipelined(u8, model.param_tree(), device=dev, stats=st)
        launches = dequant_u8.launches
        plain, _, _ = load_checkpoint(u8, model.param_tree())  # host decode, plain version
        plain = flatten(plain, "param")
        for name, t in flatten(got, "param").items():
            if t.device != dev or not torch.equal(t.cpu(), plain[name]):
                raise SystemExit(f"chip_smoke: u8 leaf {name} differs from the plain decode")
        del got, plain
        if not launches == st.dequant_leaves == float_leaves:
            raise SystemExit(f"chip_smoke: {launches} dequant launches, {st.dequant_leaves} "
                             f"dequantized leaves, {float_leaves} float leaves")
        out["u8_cold_start"] = {**_cold(st), "dequant_launches": launches}

        # raw cold start through the serving entry point
        engine = ServeEngine(model, checkpoint=raw)
        if engine.device != dev:
            raise SystemExit(f"chip_smoke: ServeEngine runs on {engine.device}, not the card")
        for name, t in flatten(model.param_tree(), "param").items():
            if t.data_ptr() == saved[name].data_ptr() or not torch.equal(t, saved[name]):
                raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
        out["raw_cold_start"] = _cold(engine.cold_start)
    del saved

    prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention.launches = flash_attention.tc_launches = decode_attention.launches = 0
    tokens = engine.generate(prompts, max_new=max_new)
    out["flash_attention_launches"] = flash_attention.launches
    out["flash_attention_tc_launches"] = flash_attention.tc_launches
    out["decode_attention_launches"] = decode_attention.launches
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(engine.throughput())
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: generate gave {tokens.shape} tokens out of range")
    if (out["flash_attention_launches"], out["decode_attention_launches"]) != (
            cfg.n_layers, cfg.n_layers * max_new):
        raise SystemExit(f"chip_smoke: {out['flash_attention_launches']} flash and "
                         f"{out['decode_attention_launches']} decode launches, wanted "
                         f"{cfg.n_layers} and {cfg.n_layers * max_new}")
    if out["flash_attention_tc_launches"] != cfg.n_layers:
        raise SystemExit(f"chip_smoke: {out['flash_attention_tc_launches']} of "
                         f"{out['flash_attention_launches']} flash launches went to the "
                         f"tensor-core kernel, wanted {cfg.n_layers}")

    # the same requests again: warm (launches from here on are not counted)
    engine.stats = {key: 0.0 for key in engine.stats}
    engine.generate(prompts, max_new=max_new)
    out["warm"] = engine.throughput()
    out["long_prefill"] = _long_prefill(torch, engine, cfg)

    # the same requests with plain attention
    first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
    with _plain_attention():
        plain_first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
        plain_tokens = engine.generate(prompts, max_new=max_new)
    scale = float(plain_first.abs().max())
    out["first_logits_max_abs_diff"] = float((first - plain_first).abs().max())
    out["first_logits_max_abs"] = scale
    out["first_logits_tolerance"] = LOGITS_TOL * scale
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())
    if not np.isfinite(out["first_logits_max_abs_diff"]) or \
            out["first_logits_max_abs_diff"] > out["first_logits_tolerance"]:
        raise SystemExit(f"chip_smoke: first-step logits differ from plain attention: {out}")
    log(f"[serving] {json.dumps(out)}")
    return out


def _long_prefill(torch, engine, cfg, S: int = 4096) -> dict:
    """One request with a 4,096-token prompt (numpy seed 1) and one new
    token: its prefill_s is where a long prompt's users see the flash
    kernel. Run twice; the second run, with the allocator warm, is the
    timed one (``long_prefill_s``), and must launch the tensor-core kernel
    once per layer."""
    import numpy as np

    from repro_torch.kernels import flash_attention

    prompt = np.random.default_rng(SEED + 1).integers(1, cfg.vocab, (1, S)).astype(np.int32)
    out = {"prompt": S, "batch": 1}
    for key in ("long_prefill_first_s", "long_prefill_s"):
        engine.stats = {k: 0.0 for k in engine.stats}
        flash_attention.launches = flash_attention.tc_launches = 0
        engine.generate(prompt, max_new=1)
        out[key] = engine.stats["prefill_s"]
    out["flash_attention_launches"] = flash_attention.launches
    out["flash_attention_tc_launches"] = flash_attention.tc_launches
    if (flash_attention.launches, flash_attention.tc_launches) != (cfg.n_layers, cfg.n_layers):
        raise SystemExit(f"chip_smoke: long prefill launched {out}, wanted {cfg.n_layers} "
                         f"tensor-core flash launches")
    return out


# --------------------------------------------------------------- phase 6
@contextlib.contextmanager
def _plain_scan():
    """The serving path with ``ops.ssd_scan`` swapped for its plain version,
    for this script's comparison only."""
    from repro_torch.kernels import ops, ref

    kept = ops.ssd_scan

    def scan(x, dtA, Bm, Cm, *, chunk=128, return_state=False):
        y, state = ref.ssd_scan_ref(x, dtA, Bm, Cm, chunk=max(1, min(chunk, x.shape[2])))
        return (y, state) if return_state else y

    ops.ssd_scan = scan
    try:
        yield
    finally:
        ops.ssd_scan = kept


def phase_ssm_serving(torch) -> dict:
    """Mamba2-780M: raw checkpoint, cold start, and a batch of requests."""
    import numpy as np

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention, ssd_scan
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("mamba2_780m")
    B, S, max_new = 8, 512, 64
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "ssm_heads": cfg.n_ssm_heads, "headdim": cfg.ssm.headdim,
                 "d_state": cfg.ssm.d_state, "chunk": cfg.ssm.chunk, "dtype": cfg.param_dtype,
                 "batch": B, "prompt": S, "max_new": max_new}
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    saved = flatten(model.param_tree(), "param")  # the random weights, kept for the check
    out["params"] = sum(t.numel() for t in saved.values())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssm_") as tmp:
        t0 = time.perf_counter()
        raw = save_checkpoint(os.path.join(tmp, "raw"), 1, model.param_tree())
        out["save_raw_s"] = time.perf_counter() - t0
        engine = ServeEngine(model, checkpoint=raw)
        if engine.device != dev:
            raise SystemExit(f"chip_smoke: ServeEngine runs on {engine.device}, not the card")
        for name, t in flatten(model.param_tree(), "param").items():
            if t.data_ptr() == saved[name].data_ptr() or not torch.equal(t, saved[name]):
                raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
        out["raw_cold_start"] = _cold(engine.cold_start)
    del saved

    prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    kernels = (dequant_u8, flash_attention, decode_attention, ssd_scan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    ssd_scan.tc_launches = 0
    tokens = engine.generate(prompts, max_new=max_new)
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    out["launches"] = launches
    out["ssd_scan_launches"] = launches["ssd_scan"]
    out["ssd_scan_tc_launches"] = ssd_scan.tc_launches
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(engine.throughput())
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: generate gave {tokens.shape} tokens out of range")
    if launches != {"dequant_u8": 0, "flash_attention": 0, "decode_attention": 0,
                    "ssd_scan": cfg.n_layers}:
        raise SystemExit(f"chip_smoke: Mamba2 generate launched {launches}, wanted "
                         f"{cfg.n_layers} ssd_scan and nothing else")
    if out["ssd_scan_tc_launches"] != cfg.n_layers:
        raise SystemExit(f"chip_smoke: {out['ssd_scan_tc_launches']} of {cfg.n_layers} "
                         f"ssd_scan launches ran the tensor-core kernels")

    # the same requests again: warm (launches from here on are not counted)
    engine.stats = {key: 0.0 for key in engine.stats}
    engine.generate(prompts, max_new=max_new)
    out["warm"] = engine.throughput()

    # the same requests with the plain scan
    first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
    with _plain_scan():
        plain_first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
        plain_tokens = engine.generate(prompts, max_new=max_new)
    scale = float(plain_first.abs().max())
    out["first_logits_max_abs_diff"] = float((first - plain_first).abs().max())
    out["first_logits_max_abs"] = scale
    out["first_logits_tolerance"] = LOGITS_TOL * scale
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())
    if not np.isfinite(out["first_logits_max_abs_diff"]) or \
            out["first_logits_max_abs_diff"] > out["first_logits_tolerance"]:
        raise SystemExit(f"chip_smoke: first-step logits differ from the plain scan: {out}")

    # where the bf16 difference comes from: the two scans differ by the order of
    # their f32 sums, which flips some bf16 roundings of y; the layers carry the
    # flips on. The hidden state's relative difference layer by layer, and the
    # same first-step comparison with the model in f32 (no bf16 rounding)
    tokens_dev = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    out["hidden_rel_diff_by_layer"] = _hidden_divergence(torch, model, tokens_dev)
    del engine, model
    f32_model = build_model(cfg.with_(param_dtype="float32", compute_dtype="float32"),
                            device=dev, seed=SEED)
    first32, _ = f32_model.prefill(tokens_dev)
    with _plain_scan():
        plain32, _ = f32_model.prefill(tokens_dev)
    out["f32_first_logits_max_abs_diff"] = float((first32 - plain32).abs().max())
    out["f32_first_logits_max_abs"] = float(plain32.abs().max())
    del f32_model
    log(f"[ssm serving] {json.dumps(out)}")
    return out


def _hidden_divergence(torch, model, tokens) -> dict:
    """Relative difference ||h_kernel - h_plain|| / ||h_plain|| of the hidden
    state after layers 1, 6, 12, 24 and 48, each path running its own scan
    from the same embeddings."""
    from repro_torch.models.common import make_norm
    from repro_torch.models.mamba import mamba_forward

    cfg = model.cfg
    _, norm = make_norm(cfg.norm)
    out = {}
    with torch.inference_mode():
        xk = xp = model._embed_inputs(tokens)
        for i, p in enumerate(model._layer_params()):
            xk = xk + mamba_forward(p["ssm"], norm(p["ln"], xk), cfg)
            with _plain_scan():
                xp = xp + mamba_forward(p["ssm"], norm(p["ln"], xp), cfg)
            if i + 1 in (1, 6, 12, 24, cfg.n_layers):
                out[str(i + 1)] = float((xk.float() - xp.float()).norm() / xp.float().norm())
    return out


# --------------------------------------------------------------- phase 7
GEMMA3_LAYERS = 12  # of 48: two periods of the 5 local : 1 global pattern


def phase_gemma3_serving(torch) -> dict:
    """gemma3-12b at full widths and 12 layers: raw checkpoint, cold start,
    and a batch of requests whose prompts are longer than the local window."""
    import numpy as np

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention, ssd_scan
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    published = get_config("gemma3_12b")
    cfg = published.with_(n_layers=GEMMA3_LAYERS)
    B, S, max_new = 4, 2048, 32
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "layers_published": published.n_layers,
                 "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                 "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                 "sliding_window": cfg.sliding_window, "global_every": cfg.global_every,
                 "dtype": cfg.param_dtype, "batch": B, "prompt": S, "max_new": max_new}
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    _temper_attention(torch, model)
    saved = flatten(model.param_tree(), "param")  # the random weights, kept for the check
    out["params"] = sum(t.numel() for t in saved.values())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_gemma3_") as tmp:
        t0 = time.perf_counter()
        raw = save_checkpoint(os.path.join(tmp, "raw"), 1, model.param_tree())
        out["save_raw_s"] = time.perf_counter() - t0
        engine = ServeEngine(model, checkpoint=raw)
        if engine.device != dev:
            raise SystemExit(f"chip_smoke: ServeEngine runs on {engine.device}, not the card")
        for name, t in flatten(model.param_tree(), "param").items():
            if t.data_ptr() == saved[name].data_ptr() or not torch.equal(t, saved[name]):
                raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
        out["raw_cold_start"] = _cold(engine.cold_start)
    del saved

    prompts = np.random.default_rng(SEED + 2).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    kernels = (dequant_u8, flash_attention, decode_attention, ssd_scan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    flash_attention.tc_launches = 0
    tokens = engine.generate(prompts, max_new=max_new)
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    out["launches"] = launches
    out["flash_attention_launches"] = launches["flash_attention"]
    out["flash_attention_tc_launches"] = flash_attention.tc_launches
    out["decode_attention_launches"] = launches["decode_attention"]
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(engine.throughput())
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: generate gave {tokens.shape} tokens out of range")
    want = {"dequant_u8": 0, "flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * max_new, "ssd_scan": 0}
    if launches != want or out["flash_attention_tc_launches"] != cfg.n_layers:
        raise SystemExit(f"chip_smoke: gemma3 generate launched {launches} "
                         f"({out['flash_attention_tc_launches']} on the tensor cores), "
                         f"wanted {want}, all flash launches on the tensor cores")

    # the same requests again: warm (launches from here on are not counted)
    engine.stats = {key: 0.0 for key in engine.stats}
    engine.generate(prompts, max_new=max_new)
    out["warm"] = engine.throughput()
    out["decode_events_per_step"] = _decode_events(torch, engine, prompts, S + max_new)

    # the same requests with plain attention
    first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
    with _plain_attention():
        plain_first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
        plain_tokens = engine.generate(prompts, max_new=max_new)
    scale = float(plain_first.abs().max())
    out["first_logits_max_abs_diff"] = float((first - plain_first).abs().max())
    out["first_logits_max_abs"] = scale
    out["first_logits_tolerance"] = LOGITS_TOL * scale
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())
    if not np.isfinite(out["first_logits_max_abs_diff"]) or \
            out["first_logits_max_abs_diff"] > out["first_logits_tolerance"]:
        raise SystemExit(f"chip_smoke: gemma3 first-step logits differ from plain attention: "
                         f"{out}")
    log(f"[gemma3 serving] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 8
PAPER_LM_STEPS, PAPER_LM_RESUME_AT = 60, 40


@contextlib.contextmanager
def _tee_stdout():
    """Print as usual and also keep what is printed (the CLI's resume line)."""
    import io

    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    buf = Tee()
    with contextlib.redirect_stdout(buf):
        yield buf


def _reset_flash_counts() -> None:
    from repro_torch.kernels import flash_attention

    flash_attention.launches = flash_attention.tc_launches = flash_attention.bwd_launches = 0


def _flash_counts() -> dict:
    from repro_torch.kernels import flash_attention

    return {"forward": flash_attention.launches, "backward": flash_attention.bwd_launches}


def _train_row(out: dict, layers: int, remat: bool) -> dict:
    st = out["loader_stats"]
    steps = len(out["losses"])
    row = {"steps": steps, "first_loss": out["losses"][0], "last_loss": out["losses"][-1],
           "wall_s": out["wall_s"], "steps_per_s": steps / out["wall_s"],
           "median_step_s": statistics.median(out["step_s"]),
           "device_wait_s": st.get("device_wait_s"),
           "h2d_gb_per_s": (st["h2d_bytes"] / st["h2d_s"] / 1e9) if st.get("h2d_s") else None,
           "h2d_bytes": st.get("h2d_bytes"), "ckpt_save_s": out["ckpt_save_s"],
           "stragglers": out["stragglers"]}
    if out["cold_start"] is not None:
        row["cold_start"] = _cold(out["cold_start"])
    row["want_launches"] = {"forward": layers * steps * (2 if remat else 1),
                            "backward": layers * steps}
    return row


def phase_paper_lm_training(torch) -> dict:
    """paper_lm through the CLI: straight, then stopped and resumed; then
    served from the trained checkpoint."""
    import numpy as np

    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, RaDataset
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.launch.train import parse_args, run
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("paper_lm")
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "vocab": cfg.vocab, "dtype": cfg.param_dtype, "batch": 8, "seq": 256}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        straight, stopped = os.path.join(tmp, "straight"), os.path.join(tmp, "resumed")
        ds = os.path.join(straight, "dataset")  # the CLI builds it on its first run

        def cli(workdir, steps, *extra):
            args = ["--arch", "paper_lm", "--device-feed", "--batch", "8", "--steps",
                    str(steps), "--ckpt-every", "20", "--seed", str(SEED), "--workdir",
                    workdir, *extra]
            _reset_flash_counts()
            with _tee_stdout() as text:
                res = run(parse_args(args))
            torch.cuda.synchronize()
            return res, text.getvalue(), _flash_counts()

        runs = {}
        for name, workdir, steps, extra in (
                ("straight", straight, PAPER_LM_STEPS, ()),
                ("first", stopped, PAPER_LM_RESUME_AT, ("--dataset", ds)),
                ("resumed", stopped, PAPER_LM_STEPS, ("--dataset", ds))):
            res, text, launches = cli(workdir, steps, *extra)
            row = _train_row(res, cfg.n_layers, cfg.remat)
            row["launches"] = launches
            if launches != row["want_launches"]:
                raise SystemExit(f"chip_smoke: paper_lm {name} run launched {launches}, "
                                 f"wanted {row['want_launches']}")
            if name == "resumed":
                row["printed_resume"] = f"[train] resumed from step {PAPER_LM_RESUME_AT}" in text
                if not row["printed_resume"]:
                    raise SystemExit("chip_smoke: the resumed run did not print "
                                     f"'[train] resumed from step {PAPER_LM_RESUME_AT}'")
            runs[name] = (row, flatten(res["params"], "param"))
        row_a, params_a = runs["straight"]
        _, params_b = runs["resumed"]
        losses_ok = row_a["last_loss"] < row_a["first_loss"]
        out["runs"] = {name: row for name, (row, _) in runs.items()}
        out["loss_falls"] = losses_ok
        out["params_bit_equal"] = all(bool(torch.equal(params_a[n], params_b[n]))
                                      for n in params_a)
        out["params_max_abs_diff"] = max(float((params_a[n] - params_b[n]).abs().max())
                                         for n in params_a)
        close = all(bool(torch.allclose(params_b[n], params_a[n], rtol=1e-5, atol=1e-6))
                    for n in params_a)
        if not losses_ok or not close:
            raise SystemExit(f"chip_smoke: paper_lm training: loss falls {losses_ok}, "
                             f"straight and resumed parameters close {close}: {out}")
        del runs, params_a, params_b

        # serve the trained checkpoint: greedy tokens equal plain attention's
        ckpt = os.path.join(stopped, "ckpt", f"step_{PAPER_LM_STEPS:08d}")
        engine = ServeEngine(build_model(cfg, device=dev, seed=SEED + 1), checkpoint=ckpt)
        prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, (2, 64)).astype(np.int32)
        tokens = engine.generate(prompts, max_new=16)
        with _plain_attention():
            plain = engine.generate(prompts, max_new=16)
        out["serve"] = {"checkpoint_step": PAPER_LM_STEPS, "cold_start": _cold(engine.cold_start),
                        "tokens_equal_plain": bool((tokens == plain).all())}
        if not out["serve"]["tokens_equal_plain"]:
            raise SystemExit(f"chip_smoke: tokens served from the trained checkpoint differ "
                             f"from plain attention's: {tokens} vs {plain}")
        host = DataLoader(RaDataset(ds), 8, seed=SEED)
        batch = {"tokens": torch.from_numpy(np.array(next(host)["tokens"]))}
        host.stop()
        out["profiled_step"] = _profiled_step(
            torch, build_model(cfg, device=dev, seed=SEED).requires_grad_(True),
            AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=200), batch)
    log(f"[paper_lm training] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 9
INTERNLM2_TRAIN_STEPS = 6
INTERNLM2_PARAMS = 1_889_110_016
#: the attention projections whose gradients phase 9 holds to plain attention's
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
#: the largest ||kernel grad − plain grad|| / ||plain grad|| of one layer's
#: attention projection in phase 9's and phase 10's first steps. On an H100
#: (700 W) InternLM2's sound step reads 0.0346 (wk; bf16 rounding carried
#: through 24 layers), its planted faults 0.106 (dq 10% too large) and 1.0 (dk
#: zeroed); gemma3's (12 layers, head width 256) 0.0123, 0.102 and 1.0: PERF.md §6
ATTN_GRAD_TOL = 0.05


@functools.lru_cache(maxsize=None)
def _kernel_names(source: str) -> tuple:
    """The ``__global__`` functions a CUDA source of the port defines."""
    from repro_torch.kernels import _build

    text = (Path(_build.CSRC) / source).read_text()
    found = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", text)
    if not found:
        raise SystemExit(f"chip_smoke: no __global__ function found in {source}")
    return tuple(sorted(set(found)))


def _kernel_kind(name: str) -> str:
    """The kind of a device event of a train step, by the kernel's name: the
    attention kernels by the ``__global__`` functions of their sources, so a
    renamed kernel is still counted as what it is."""
    for source, kind in (("flash_attention_bwd.cu", "attention backward"),
                         ("flash_attention.cu", "attention forward")):
        if any(k in name for k in _kernel_names(source)):  # demangled or mangled
            return kind
    if any(tag in name for tag in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def _profiled_step(torch, model, adamw, batch) -> dict:
    """One more train step under the profiler (after the checks: it moves the
    weights), in two traces: the forward and backward, then the optimizer.
    For each, its wall time, the summed device time of its kernels by kind,
    and the share of the wall time the card had no kernel running."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed import optimizer as optim

    params = model.param_tree()
    state = optim.init_state(params, adamw)

    def forward_backward():
        loss, _ = model.train_loss(batch)
        loss.backward()

    def update():
        optim.apply_updates(params, optim.tree_map(lambda p: p.grad, params), state, adamw)
        for p in optim.leaves(params):
            p.grad = None

    forward_backward()  # warm: the moments and the allocator
    update()
    torch.cuda.synchronize()
    out = {}
    for name, fn in (("forward_backward", forward_backward), ("optimizer", update)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kind = defaultdict(float)
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                by_kind[_kernel_kind(evt.name)] += evt.time_range.elapsed_us() / 1e3
        device_ms = sum(by_kind.values())
        out[name] = {"wall_ms": wall_ms, "device_ms": device_ms,
                     "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
                     "device_ms_by_kind": dict(by_kind)}
    kinds = out["forward_backward"]["device_ms_by_kind"]
    if not (kinds.get("attention forward") and kinds.get("attention backward")):
        raise SystemExit(f"chip_smoke: the profiled step shows no attention forward or "
                         f"backward kernel by name: {kinds}")
    del state
    return out


def _first_step(torch, model, batch) -> tuple:
    """Loss, global gradient norm and a copy of the attention projections'
    gradients (``ATTN_LEAVES``, stacked over the layers) of one forward and
    backward; the model's gradients are freed."""
    from repro_torch.distributed import optimizer as optim

    loss, _ = model.train_loss(batch)
    loss.backward()
    params = model.param_tree()
    norm = float(optim.global_norm(optim.tree_map(lambda p: p.grad, params)))
    attn = params["dense_layers"]["attn"]
    grads = {n: attn[n].grad.clone() for n in ATTN_LEAVES}
    for p in optim.leaves(params):
        p.grad = None
    return float(loss.detach()), norm, grads


def _attention_grad_err(torch, got: dict, want: dict) -> dict:
    """For each attention projection, over the layers: the largest
    ||got − want|| / ||want|| of a layer's gradient ("err"), and the largest
    relative difference of a layer's gradient norm ("norm")."""
    out = {}
    for n in ATTN_LEAVES:
        g = got[n].float().flatten(1)
        w = want[n].float().flatten(1)
        ref_norm = w.norm(dim=1)
        out[n] = {"err": float(((g - w).norm(dim=1) / ref_norm).max()),
                  "norm": float(((g.norm(dim=1) - ref_norm).abs() / ref_norm).max())}
    return out


@contextlib.contextmanager
def _planted_backward_fault(which: str):
    """The backward kernel with a planted fault in one of its outputs (dk
    zeroed, or dq 10% too large), for the control of phase 9's gradient gate."""
    from repro_torch.kernels import flash_attention as fa

    kept = fa.flash_attention_bwd

    def faulty(*args, **kwargs):
        dq, dk, dv = kept(*args, **kwargs)
        if which == "dk_zeroed":
            return dq, dk.zero_(), dv
        return dq.mul_(1.1), dk, dv

    fa.flash_attention_bwd = faulty
    try:
        yield
    finally:
        fa.flash_attention_bwd = kept


def _first_step_gates(torch, model, batch, name: str, out: dict) -> dict:
    """The first train step of ``model`` on ``batch`` against the same step
    with plain attention: the loss within 1%, the global gradient norm within
    2%, each layer's wq/wk/wv/wo gradient within ``ATTN_GRAD_TOL``; then the
    same step with each planted backward fault, which must break the last
    gate. Fails the run on any miss; returns the readings."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_k, norm_k, grads_k = _first_step(torch, model, batch)
    out["first_step_s_kernels"] = time.perf_counter() - t0
    with _plain_attention():
        loss_p, norm_p, grads_p = _first_step(torch, model, batch)
    attn_err = _attention_grad_err(torch, grads_k, grads_p)
    first = {"loss": loss_k, "plain_loss": loss_p, "grad_norm": norm_k,
             "plain_grad_norm": norm_p,
             "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
             "grad_norm_rel_diff": abs(norm_k - norm_p) / norm_p,
             "attention_grads": attn_err,
             "attention_grad_err": max(e["err"] for e in attn_err.values()),
             "attention_grad_tolerance": ATTN_GRAD_TOL}
    del grads_k
    # the control: the same step with a fault planted in the backward's
    # output must fail the gradient gate
    first["planted_faults"] = {}
    for fault in ("dk_zeroed", "dq_times_1.1"):
        with _planted_backward_fault(fault):
            _, _, grads_f = _first_step(torch, model, batch)
        err = _attention_grad_err(torch, grads_f, grads_p)
        first["planted_faults"][fault] = {
            "attention_grads": err,
            "attention_grad_err": max(e["err"] for e in err.values())}
        del grads_f
    del grads_p
    log(f"[{name} training] first step {json.dumps(first)}")
    caught = all(f["attention_grad_err"] > ATTN_GRAD_TOL
                 for f in first["planted_faults"].values())
    if not (first["loss_rel_diff"] <= 0.01 and first["grad_norm_rel_diff"] <= 0.02
            and first["attention_grad_err"] <= ATTN_GRAD_TOL):
        raise SystemExit(f"chip_smoke: {name}'s first step differs from plain "
                         f"attention's: {first}")
    if not caught:
        raise SystemExit(f"chip_smoke: the attention-gradient gate let a planted "
                         f"backward fault through ({name}): {first['planted_faults']}")
    return first


def phase_internlm2_training(torch) -> dict:
    """InternLM2-1.8B at full size: 6 train steps, a checkpoint, its restore."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import ColdStartStats, restore_pipelined
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset, make_token_dataset
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.models import build_model
    from repro_torch.train import TrainLoopConfig, train

    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2_1_8b")
    B, S = 4, 2048
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                 "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.param_dtype,
                 "remat": cfg.remat, "batch": B, "seq": S, "steps": INTERNLM2_TRAIN_STEPS}
    model = build_model(cfg, device=dev, seed=SEED)
    _temper_attention(torch, model)
    model.requires_grad_(True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_internlm2_") as tmp:
        root = os.path.join(tmp, "tokens")
        make_token_dataset(root, n_docs=64, seq_len=S, vocab=cfg.vocab, seed=3, shard_rows=64)

        # the first step against plain attention: same weights, same batch
        host = DataLoader(RaDataset(root), B, seed=SEED)
        batch = {"tokens": torch.from_numpy(np.array(next(host)["tokens"]))}
        host.stop()
        out["first_step"] = _first_step_gates(torch, model, batch, "InternLM2", out)
        torch.cuda.empty_cache()

        ckpt_dir = os.path.join(tmp, "ckpt")
        out["disk_free_bytes_before_save"] = shutil.disk_usage(tmp).free
        feed = DeviceLoader(DataLoader(RaDataset(root), B, seed=SEED, reuse_buffers=True),
                            device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_flash_counts()
        res = train(model, feed, TrainLoopConfig(
            steps=INTERNLM2_TRAIN_STEPS, ckpt_every=INTERNLM2_TRAIN_STEPS, ckpt_dir=ckpt_dir,
            log_every=1, adamw=AdamWConfig(lr=1e-3, warmup_steps=2)), resume=False)
        torch.cuda.synchronize()
        launches = _flash_counts()
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
        row = _train_row(res, cfg.n_layers, cfg.remat)
        row["launches"] = launches
        row["losses"] = res["losses"]
        row["step_s"] = res["step_s"]
        step_s = statistics.median(res["step_s"][1:])
        row["tokens_per_s"] = B * S / step_s
        row["model_tflops_per_s"] = 6 * INTERNLM2_PARAMS * B * S / step_s / 1e12
        out["train"] = row
        finite = all(np.isfinite(res["losses"]))
        if not finite or res["losses"][-1] >= res["losses"][0]:
            raise SystemExit(f"chip_smoke: InternLM2 training: losses {res['losses']}")
        if launches != row["want_launches"]:
            raise SystemExit(f"chip_smoke: InternLM2 training launched {launches}, wanted "
                             f"{row['want_launches']}")

        # the checkpoint at the last step: params and optimizer state, restored
        # by the cold start, every leaf bit-equal to the live state it saved
        path = os.path.join(ckpt_dir, f"step_{INTERNLM2_TRAIN_STEPS:08d}")
        saved_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        params, opt_state = res["params"], res["opt_state"]
        for p in model.parameters():
            p.grad = None
        del res
        torch.cuda.empty_cache()
        st = ColdStartStats()
        got_p, got_o, extra = restore_pipelined(path, params, opt_state, device=dev, stats=st)
        live = {**flatten(params, "param"), **flatten(opt_state, "opt")}
        restored = {**flatten(got_p, "param"), **flatten(got_o, "opt")}
        equal = set(live) == set(restored) and all(
            bool(torch.equal(restored[n], live[n])) for n in live)
        out["checkpoint"] = {"bytes": saved_bytes, "leaves": len(restored),
                             "save_s": row["ckpt_save_s"],
                             "save_gb_per_s": saved_bytes / row["ckpt_save_s"] / 1e9,
                             "restore": _cold(st), "restore_bit_equal": equal,
                             "extra_keys": sorted(extra)}
        del got_p, got_o, restored, live, opt_state
        if not equal:
            raise SystemExit("chip_smoke: the InternLM2 train checkpoint did not restore "
                             "bit-equal")
    torch.cuda.empty_cache()
    out["profiled_step"] = _profiled_step(torch, model, AdamWConfig(lr=1e-3, warmup_steps=2),
                                          batch)
    del model, params
    torch.cuda.empty_cache()
    log(f"[internlm2 training] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 10
GEMMA3_TRAIN_STEPS = 4


def phase_gemma3_training(torch) -> dict:
    """gemma3-12b at full widths and 12 of 48 layers: the first step against
    plain attention (head width 256, local and global layers), then 4 steps
    of the train loop's step; no checkpoint (phases 8 and 9 hold that path)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset, make_token_dataset
    from repro_torch.distributed import optimizer as optim
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.models import build_model
    from repro_torch.train.loop import make_step

    dev = torch.device("cuda", 0)
    published = get_config("gemma3_12b")
    cfg = published.with_(n_layers=GEMMA3_LAYERS)
    B, S, steps = 2, 2048, GEMMA3_TRAIN_STEPS
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "layers_published": published.n_layers,
                 "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                 "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                 "sliding_window": cfg.sliding_window, "global_every": cfg.global_every,
                 "dtype": cfg.param_dtype, "remat": cfg.remat, "batch": B, "seq": S,
                 "steps": steps}
    model = build_model(cfg, device=dev, seed=SEED)
    _temper_attention(torch, model)
    model.requires_grad_(True)
    out["params"] = sum(p.numel() for p in model.parameters())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gemma3_train_") as tmp:
        root = os.path.join(tmp, "tokens")
        make_token_dataset(root, n_docs=16, seq_len=S, vocab=cfg.vocab, seed=4, shard_rows=16)
        host = DataLoader(RaDataset(root), B, seed=SEED)
        batch = {"tokens": torch.from_numpy(np.array(next(host)["tokens"]))}
        host.stop()
        out["first_step"] = _first_step_gates(torch, model, batch, "gemma3", out)
        torch.cuda.empty_cache()

        # the steps train() runs (its make_step) on DeviceLoader batches; train()
        # itself saves a checkpoint at its end, here 37 GB of parameters and moments
        adamw = AdamWConfig(lr=1e-3, warmup_steps=2)
        params = model.param_tree()
        state = optim.init_state(params, adamw)
        step_fn = make_step(model, adamw)
        feed = DeviceLoader(DataLoader(RaDataset(root), B, seed=SEED, reuse_buffers=True),
                            device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_flash_counts()
        losses, step_s = [], []
        try:
            for _ in range(steps):
                feed_batch = next(feed)
                feed_batch.pop("_state", None)
                t0 = time.perf_counter()
                params, state, metrics = step_fn(params, state, feed_batch)
                losses.append(float(metrics["loss"]))
                step_s.append(time.perf_counter() - t0)
        finally:
            feed.stop()
        torch.cuda.synchronize()
    launches = _flash_counts()
    step = statistics.median(step_s[1:])
    row = {"steps": steps, "losses": losses, "step_s": step_s, "median_step_s": step,
           "tokens_per_s": B * S / step,
           "model_tflops_per_s": 6 * out["params"] * B * S / step / 1e12,
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev), "launches": launches,
           "want_launches": {"forward": cfg.n_layers * steps * (2 if cfg.remat else 1),
                             "backward": cfg.n_layers * steps}}
    out["train"] = row
    log(f"[gemma3 training] steps {json.dumps(row)}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise SystemExit(f"chip_smoke: gemma3 training: losses {losses}")
    if launches != row["want_launches"]:
        raise SystemExit(f"chip_smoke: gemma3 training launched {launches}, wanted "
                         f"{row['want_launches']}")
    del state, params
    torch.cuda.empty_cache()
    out["profiled_step"] = _profiled_step(torch, model, adamw, batch)
    del model
    torch.cuda.empty_cache()
    log(f"[gemma3 training] {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 11
#: prefill vs replay of the f32 copy: tests/test_models.py:63-78's tolerance,
#: atol of the logits' scale
F32_REPLAY_TOL = (2e-3, 2e-4)


def _first_logits_gate(torch, out: dict, key: str, got, plain, what: str) -> None:
    """Record ``got`` against ``plain`` under ``key`` and fail beyond
    ``LOGITS_TOL`` of the plain logits' scale."""
    import numpy as np

    scale = float(plain.abs().max())
    diff = float((got - plain).abs().max())
    out[key] = {"max_abs_diff": diff, "max_abs": scale, "tolerance": LOGITS_TOL * scale}
    if not np.isfinite(diff) or diff > LOGITS_TOL * scale:
        raise SystemExit(f"chip_smoke: Zamba2 {what} differ from the plain versions': {out}")


def _profiled_steps(torch, model, prompts, capacity: int, n: int = 8) -> dict:
    """Wall and device time of ``n`` decode steps under the profiler, fed
    as the engine's replay feeds them (the prompt's tokens) and as its decode
    loop does (the argmax of the last logits), on one cache; both traced
    twice, the second pass kept. Per step: wall ms, device ms (the summed
    kernel durations) and the share of the wall time the card had no kernel
    running."""
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.from_numpy(prompts[:, :n].astype("int64")).to(model.device)
    cache = model.empty_cache(tokens.shape[0], capacity)  # room for 4n + 1 steps
    logits, cache = model.decode_step(cache, tokens[:, :1])
    out = {}
    feeds = (("replay", lambda i, _: tokens[:, i:i + 1]),
             ("decode", lambda i, lg: lg.argmax(-1, keepdim=True)))
    for name, feed in feeds + feeds:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                logits, cache = model.decode_step(cache, feed(i, logits))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out[name] = {"steps": n, "wall_ms_per_step": wall_ms / n,
                     "device_ms_per_step": device_ms / n,
                     "device_idle_share": max(0.0, 1 - device_ms / wall_ms)}
    return out


def phase_zamba2_serving(torch) -> dict:
    """Zamba2-1.2B at its full size: raw checkpoint, cold start, a batch of
    requests served through the engine's prompt replay, then the model's
    chunked prefill and an f32 copy's prefill against its replay."""
    import numpy as np

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, dequant_u8, flash_attention, ssd_scan
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_params
    from repro_torch.serving import ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("zamba2_1_2b")
    B, S, max_new = 8, 256, 32
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    n_inv = len(model.invocations)
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
                 "invocations": n_inv, "shared_heads": cfg.n_heads,
                 "shared_kv_heads": cfg.n_kv_heads, "shared_head_dim": model.attn_cfg.head_dim,
                 "d_ff": cfg.d_ff, "ssm_heads": cfg.n_ssm_heads, "headdim": cfg.ssm.headdim,
                 "d_state": cfg.ssm.d_state, "chunk": cfg.ssm.chunk, "vocab": cfg.vocab,
                 "dtype": cfg.param_dtype, "batch": B, "prompt": S, "max_new": max_new,
                 "init_s": time.perf_counter() - t0}
    _temper_attention(torch, model)
    saved = flatten(model.param_tree(), "param")  # the random weights, kept for the check
    out["params"] = sum(t.numel() for t in saved.values())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_zamba2_") as tmp:
        t0 = time.perf_counter()
        raw = save_checkpoint(os.path.join(tmp, "raw"), 1, model.param_tree())
        out["save_raw_s"] = time.perf_counter() - t0
        engine = ServeEngine(model, checkpoint=raw)
        if engine.device != dev:
            raise SystemExit(f"chip_smoke: ServeEngine runs on {engine.device}, not the card")
        for name, t in flatten(model.param_tree(), "param").items():
            if t.data_ptr() == saved[name].data_ptr() or not torch.equal(t, saved[name]):
                raise SystemExit(f"chip_smoke: restored leaf {name} is not the saved one")
        out["raw_cold_start"] = _cold(engine.cold_start)
    del saved

    # the main generate: the prompt replayed through decode_step, then 31 steps
    prompts = np.random.default_rng(SEED + 3).integers(1, cfg.vocab, (B, S)).astype(np.int32)
    kernels = (dequant_u8, flash_attention, decode_attention, ssd_scan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in kernels:
        k.launches = 0
    tokens = engine.generate(prompts, max_new=max_new)
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    out["launches"] = launches
    out["decode_attention_launches"] = launches["decode_attention"]
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    out.update(engine.throughput())
    if tokens.shape != (B, max_new) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise SystemExit(f"chip_smoke: generate gave {tokens.shape} tokens out of range")
    want = {"dequant_u8": 0, "flash_attention": 0,
            "decode_attention": n_inv * (S + max_new - 1), "ssd_scan": 0}
    if launches != want:
        raise SystemExit(f"chip_smoke: Zamba2 generate launched {launches}, wanted {want}")

    # the same requests again: warm (launches from here on are not counted)
    engine.stats = {key: 0.0 for key in engine.stats}
    engine.generate(prompts, max_new=max_new)
    out["warm"] = engine.throughput()
    out["warm"]["ms_per_replayed_token"] = out["warm"]["prefill_s"] / S * 1e3
    out["warm"]["ms_per_decode_step"] = out["warm"]["decode_s"] / (max_new - 1) * 1e3
    out["profiled_steps"] = _profiled_steps(torch, model, prompts, S + max_new)

    # the same requests with both attention ops and the scan plain
    first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
    with _plain_attention(), _plain_scan():
        plain_first = engine._prefill_with_capacity(prompts, S + max_new)[0].float()
        plain_tokens = engine.generate(prompts, max_new=max_new)
    _first_logits_gate(torch, out, "first_logits", first, plain_first, "first-step logits")
    out["first_token_agreement"] = float((tokens[:, 0] == plain_tokens[:, 0]).mean())
    out["greedy_token_agreement"] = float((tokens == plain_tokens).mean())

    # the chunked prefill: 6 flash and 38 ssd_scan launches, all on the tensor cores
    tokens_dev = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    for k in (flash_attention, ssd_scan):
        k.launches = k.tc_launches = 0
    prefill_logits = model.prefill(tokens_dev)[0].float()
    torch.cuda.synchronize()
    pf = {"flash_attention": flash_attention.launches,
          "flash_attention_tc": flash_attention.tc_launches,
          "ssd_scan": ssd_scan.launches, "ssd_scan_tc": ssd_scan.tc_launches}
    out["prefill_launches"] = pf
    want = {"flash_attention": n_inv, "flash_attention_tc": n_inv,
            "ssd_scan": cfg.n_layers, "ssd_scan_tc": cfg.n_layers}
    if pf != want:
        raise SystemExit(f"chip_smoke: Zamba2 prefill launched {pf}, wanted {want}")
    t0 = time.perf_counter()
    model.prefill(tokens_dev)
    torch.cuda.synchronize()
    out["model_prefill_s"] = time.perf_counter() - t0  # warm: the chunked path's time
    with _plain_attention(), _plain_scan():
        plain_prefill = model.prefill(tokens_dev)[0].float()
    _first_logits_gate(torch, out, "prefill_logits", prefill_logits, plain_prefill,
                       "prefill logits")
    out["prefill_vs_replay_bf16"] = {
        "max_abs_diff": float((prefill_logits - first).abs().max()),
        "max_abs": float(first.abs().max()),
        "argmax_agreement": float((prefill_logits.argmax(-1) == first.argmax(-1))
                                  .float().mean())}

    # an f32 copy of the weights: its chunked prefill against its replay
    f32 = build_model(cfg.with_(param_dtype="float32", compute_dtype="float32"), device="meta")
    load_params(f32, _float32(torch, model.param_tree()))
    del engine, model
    torch.cuda.empty_cache()
    pf32 = f32.prefill(tokens_dev)[0]
    replay32 = ServeEngine(f32)._prefill_with_capacity(prompts, S)[0]
    rtol, atol = F32_REPLAY_TOL
    scale = float(replay32.abs().max())
    out["f32_prefill_vs_replay"] = {
        "max_abs_diff": float((pf32 - replay32).abs().max()), "max_abs": scale,
        "rtol": rtol, "atol": atol * scale,
        "argmax_agreement": float((pf32.argmax(-1) == replay32.argmax(-1)).float().mean())}
    ok = bool(torch.allclose(pf32, replay32, rtol=rtol, atol=atol * scale))
    del f32, pf32, replay32
    torch.cuda.empty_cache()
    log(f"[zamba2 serving] {json.dumps(out)}")
    if not ok:
        raise SystemExit(f"chip_smoke: Zamba2's f32 prefill and replay differ: "
                         f"{out['f32_prefill_vs_replay']}")
    return out


def _decode_events(torch, engine, prompts, capacity: int, attempts: int = 3) -> int:
    """Device events of ``decode_attention`` in one traced decode step: one a
    layer, the kernel and nothing else (no fold kernel, no copy of pos). A
    trace that shows another count is taken again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import decode_attention

    logits, cache = engine._prefill_with_capacity(prompts, capacity)
    step = logits.argmax(-1, keepdim=True)
    layers = engine.cfg.n_layers
    for _ in range(attempts):
        torch.cuda.synchronize()
        before = decode_attention.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            logits, cache = engine.model.decode_step(cache, step)
            torch.cuda.synchronize()
        cache["pos"] = cache["pos"] - 1  # the same step again on the next attempt
        events = sum("decode_attention" in e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        if events == decode_attention.launches - before == layers:
            return events
        log(f"[gemma3 serving] a traced decode step showed {events} decode events for "
            f"{decode_attention.launches - before} launches, wanted {layers}")
    raise SystemExit(f"chip_smoke: {attempts} traced decode steps did not show one "
                     f"decode_attention event a layer")


def _float32(torch, tree):
    """A copy of a nested dict of tensors with the float leaves in float32."""
    if isinstance(tree, dict):
        return {k: _float32(torch, v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _cold(st) -> dict:
    return {"seconds": st.restore_s, "leaves": st.leaves, "logical_bytes": st.logical_bytes,
            "stored_bytes": st.stored_bytes, "logical_gb_per_s": st.logical_bytes / st.restore_s / 1e9,
            "stored_gb_per_s": st.stored_bytes / st.restore_s / 1e9, "h2d_s": st.h2d_s,
            "peak_inflight_bytes": st.peak_inflight_bytes}


# --------------------------------------------------------------- main
def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    t_start = time.perf_counter()
    card = phase_environment(torch)
    build_s = phase_build()
    sass = phase_sass()
    rows = phase_kernels(torch)
    flash_rows, decode_rows = phase_attention(torch)
    ssd_rows = phase_ssd(torch)
    bwd_rows = phase_attention_bwd(torch)
    runs = phase_main_path(torch)
    serve = phase_serving(torch)
    torch.cuda.empty_cache()
    ssm = phase_ssm_serving(torch)
    torch.cuda.empty_cache()
    gemma = phase_gemma3_serving(torch)
    torch.cuda.empty_cache()
    small = phase_paper_lm_training(torch)
    torch.cuda.empty_cache()
    big = phase_internlm2_training(torch)
    torch.cuda.empty_cache()
    g_train = phase_gemma3_training(torch)
    torch.cuda.empty_cache()
    zamba = phase_zamba2_serving(torch)

    main_row = rows[0]  # the CIFAR batch: the shape every epoch batch of the feed has
    feed_launches = {r["name"]: r["launches"] for r in runs}
    kernels = [{
        "name": "dequant_u8",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dequant_u8.cu",
        "replaces": "src/repro/kernels/dequant_u8.py:31",
        "launches": sum(feed_launches.values()) + serve["u8_cold_start"]["dequant_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "tolerance": 0.0,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        "library_call": "torch.addcmul(bias, x_uint8, scale)",
        "exact": all(r["exact"] for r in rows),
        "build_s": build_s,
        "shapes": rows,
        "main_path_launches": {**feed_launches,
                               "u8_cold_start": serve["u8_cold_start"]["dequant_launches"]},
    }]
    def by_phase(key):
        return {serve["arch"]: serve[key], gemma["arch"]: gemma[key]}

    def train_launches(kind):
        runs = {f"{small['arch']} train ({name})": row["launches"][kind]
                for name, row in small["runs"].items()}
        runs[f"{big['arch']} train"] = big["train"]["launches"][kind]
        runs[f"{g_train['arch']} train"] = g_train["train"]["launches"][kind]
        return runs

    zamba_prefill = f"{zamba['arch']} prefill"
    for name, replaces, rows_, launches, call in (
        ("flash_attention", "src/repro/kernels/flash_attention.py:66", flash_rows,
         {**by_phase("flash_attention_launches"), **train_launches("forward"),
          zamba_prefill: zamba["prefill_launches"]["flash_attention"]},
         "torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True, "
         "enable_gqa=True)"),
        ("decode_attention", "src/repro/kernels/decode_attention.py:61", decode_rows,
         {**by_phase("decode_attention_launches"),
          zamba["arch"]: zamba["decode_attention_launches"]},
         "torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=kpos <= pos, "
         "enable_gqa=True)"),
        ("ssd_scan", "src/repro/kernels/ssd_scan.py:68", ssd_rows,
         {ssm["arch"]: ssm["ssd_scan_launches"],
          zamba_prefill: zamba["prefill_launches"]["ssd_scan"]}, None),
    ):
        main = rows_[0]  # the shape the serving path gives the kernel
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(launches.values()),
            "main_path_launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows_),
            "tolerance": main["tolerance"],
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_call": call,
            "shapes": rows_,
        })
        kernels[-1]["sass"] = sass[f"{name}.cu"]
        if name == "flash_attention":
            kernels[-1]["tc_launches"] = sum(by_phase("flash_attention_tc_launches").values()) \
                + zamba["prefill_launches"]["flash_attention_tc"]
        if name == "ssd_scan":
            kernels[-1]["tc_launches"] = ssm["ssd_scan_tc_launches"] \
                + zamba["prefill_launches"]["ssd_scan_tc"]
    main = bwd_rows[0]  # paper_lm's training shape: the north star's train step
    kernels.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:66 (its gradient, which the JAX "
                    "train step leaves to XLA: src/repro/train/loop.py:61)",
        "launches": sum(train_launches("backward").values()),
        "main_path_launches": train_launches("backward"),
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "tolerance": main["tolerance"],
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_call": "torch.autograd.grad of torch.nn.functional.scaled_dot_product_attention"
                        "(q, k, v, is_causal=True), K/V repeated over the group",
        "shapes": bwd_rows,
        "sass": sass["flash_attention_bwd.cu"],
    })
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
