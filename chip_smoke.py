#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases (any failure exits non-zero and prints no result):

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: ``nvcc`` compiles every CUDA source of the port into ``build/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it and at edge shapes, required bit-equal;
   the device time of the kernel, of the plain version and of one library
   call computing the same function (profiler trace of 25 calls, L2 flushed
   before each), and the kernel's time between two CUDA events (median of
   25, launch overhead included), beside the least time the card's memory
   allows (data-sheet 3.35 TB/s);
4. the main path: the device feed over a CIFAR-10-shaped RawArray dataset
   (50,000 × 32×32×3, uint8 codes on disk) for one full epoch at batch 512,
   then 8 batches of an ImageNet-shaped one (2,048 × 224×224×3, batch 256),
   every batch held against the host decode of the same batch.

The last two lines are one JSON object listing each kernel, and the result
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
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


def _device_ms(torch, fn, flush) -> float:
    """Device time of one call: the summed durations of the kernels it ran,
    from a profiler trace of REPS calls (L2 flushed before each; the flush's
    own fill kernels are left out), divided by REPS. Host launch overhead
    and gaps between a call's kernels are not in it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    names = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "FillFunctor" in evt.name or evt.name == "Activity Buffer Request":
            continue
        total_us += evt.time_range.elapsed_us()
        names.append(evt.name)
    if not names or len(names) % REPS:
        raise SystemExit(f"chip_smoke: the profiler saw {len(names)} device events in "
                         f"{REPS} calls: {sorted(set(names))}")
    return total_us / REPS / 1e3


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
        row = {
            "case": label, "shape": list(shape), "out_dtype": str(out_dtype).split(".")[-1],
            "data_ptr_mod_16": int(x.data_ptr() % 16), "exact": exact, "max_abs_err": err,
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
    rows = phase_kernels(torch)
    runs = phase_main_path(torch)

    main_row = rows[0]  # the CIFAR batch: the shape every epoch batch of the main path has
    kernel = {
        "name": "dequant_u8",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dequant_u8.cu",
        "replaces": "src/repro/kernels/dequant_u8.py:31",
        "launches": sum(r["launches"] for r in runs),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_row["library_ms"],
        "library_call": "torch.addcmul(bias, x_uint8, scale)",
        "exact": all(r["exact"] for r in rows),
        "build_s": build_s,
        "shapes": rows,
        "main_path_launches": {r["name"]: r["launches"] for r in runs},
    }
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
