#!/usr/bin/env python3
"""Peak device memory of ``chip_smoke.py``'s phase 17 (llava-next-mistral-7b
training at full widths) at the depths given, on one CUDA card: how deep the
cut of its 32 layers can go under the card's 80 GB.

    python3 tools/llava_depth_probe.py 12 22     # from the repository root

For each depth, runs the phase (first-step gates, 4 steps of ``make_step``,
a profiled step) and prints its peak, step time and losses, or the failure.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("llava_depth_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs.phase_environment(torch), flush=True)
    for layers in (int(a) for a in argv):
        cs.LLAVA_TRAIN_LAYERS = layers
        try:
            out = cs.phase_llava_training(torch)
            row = {"peak_device_bytes": out["train"]["peak_device_bytes"],
                   "median_step_s": out["train"]["median_step_s"],
                   "losses": out["train"]["losses"]}
        except (SystemExit, torch.OutOfMemoryError) as e:
            row = {"failed": str(e)[:400], "max_allocated": torch.cuda.max_memory_allocated()}
        print(f"[llava depth] {layers} {json.dumps(row)}", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
