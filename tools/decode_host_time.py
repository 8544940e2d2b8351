"""Wall time of a decode step at full size, for comparing two trees of the
port on one card: the decode paths are host-bound, so what a change adds to
the Python of a step shows here first.

For each arch: random weights from a seed, an empty cache of 8 rows and 576
positions, ``WARM`` decode steps, then ``ROUNDS`` rounds of ``STEPS`` steps
fed the argmax of the last logits (as a decode loop feeds them), synchronized
at each round's end. Prints one JSON line an arch with the wall ms a step of
each round and their median, then the card's name and power limit.

Run it with the tree under test first on ``PYTHONPATH``, e.g. parent and
change alternately from one call::

    PYTHONPATH=../parent/src python3 tools/decode_host_time.py
    PYTHONPATH=src python3 tools/decode_host_time.py
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

ARCHS = ("internlm2_1_8b", "mamba2_780m", "zamba2_1_2b", "llava_next_mistral_7b",
         "whisper_medium")
BATCH, CAPACITY = 8, 576
WARM, STEPS, ROUNDS = 4, 32, 3


def time_arch(arch: str) -> dict:
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    model = build_model(cfg, device=dev, seed=0)
    cache = model.empty_cache(BATCH, CAPACITY)
    tokens = torch.ones((BATCH, 1), dtype=torch.long, device=dev)
    for _ in range(WARM):
        logits, cache = model.decode_step(cache, tokens)
        tokens = logits.argmax(-1, keepdim=True)
    rounds = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            logits, cache = model.decode_step(cache, tokens)
            tokens = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / STEPS * 1e3)
    del model, cache
    torch.cuda.empty_cache()
    return {"arch": arch, "tree": repro_torch.__file__, "batch": BATCH, "steps": STEPS,
            "wall_ms_per_step": rounds, "median_ms_per_step": statistics.median(rounds)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_host_time: no CUDA device")
    with torch.inference_mode():
        for arch in args.arch:
            print(json.dumps(time_arch(arch)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
