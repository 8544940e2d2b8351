#!/usr/bin/env python3
"""What the training forward of ``flash_attention`` costs beside the serving
forward, and what the dense training steps take, for one checkout of the
repository, on one CUDA card. Run it on two checkouts in one call to compare
them (parent, change, change, parent):

    python3 tools/train_forward_cost.py --root .
    python3 tools/train_forward_cost.py --root <another checkout>

Imports ``repro_torch`` and ``chip_smoke.py`` from ``--root``, builds that
checkout's kernels (``chip_smoke.phase_build``), then times
``flash_attention_fwd`` with ``return_lse=True`` (what training runs) and
without it (what serving runs) at the training shapes of ``chip_smoke.py``'s
phase 3d, by ``chip_smoke._device_ms`` (profiler, L2 flushed, mean of its
calls), and runs that checkout's phases 9 (InternLM2-1.8B) and 10 (gemma3-12b,
12 layers) for their step seconds. The last line is one JSON object.
"""

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

# (label, B, H, KV, Sq, Sk, hd, causal, window): phase 3d's bf16 training shapes
SHAPES = [
    ("internlm2_train", 4, 16, 8, 2048, 2048, 128, True, 0),
    ("gemma3_train_local", 2, 16, 8, 2048, 2048, 256, True, 1024),
    ("gemma3_train_global", 2, 16, 8, 2048, 2048, 256, True, 0),
    ("whisper_encoder_train", 8, 16, 16, 1500, 1500, 64, False, 0),
    ("whisper_cross_train", 8, 16, 16, 448, 1500, 64, False, 0),
    ("whisper_decoder_train", 8, 16, 16, 448, 448, 64, True, 0),
    ("llava_train", 2, 32, 8, 4096, 4096, 128, True, 4096),
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout to measure")
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("train_forward_cost: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    print(cs.phase_environment(torch), flush=True)
    cs.phase_build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    result: dict = {"root": str(root), "forward": {}}
    for label, B, H, KV, Sq, Sk, hd, causal, window in SHAPES:
        q = torch.randn((B, H, Sq, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, KV, Sk, hd), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        row = {}
        for key, lse in (("train_ms", True), ("serve_ms", False)):
            row[key] = cs._device_ms(torch, lambda lse=lse: fa.flash_attention_fwd(
                q, k, v, causal=causal, window=window, return_lse=lse), flush)
        row["train_over_serve"] = row["train_ms"] / row["serve_ms"]
        result["forward"][label] = row
        print(f"[forward] {label} {json.dumps(row)}", flush=True)
        del q, k, v
    del flush
    torch.cuda.empty_cache()
    for name, phase in (("internlm2", cs.phase_internlm2_training),
                        ("gemma3", cs.phase_gemma3_training)):
        with contextlib.redirect_stdout(sys.stderr):  # the phase's own log
            out = phase(torch)
        train = out["train"]
        result[name] = {"step_s": train["step_s"],
                        "median_step_s_after_first": statistics.median(train["step_s"][1:])}
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
