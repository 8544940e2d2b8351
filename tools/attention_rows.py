"""Device times of the attention kernels' rows in ``chip_smoke.py``'s phase
3b (``phase_attention``) for one checkout, for comparing two trees on one
card: the rows are built, checked and timed by that checkout's own
``chip_smoke.py``, so both sides are timed the same way.

Prints one JSON line a decode row (``ROW {...}``: the case, device ms,
event ms, plain and library ms, bound) and then the card's name and power
limit. Run the trees alternately from one call, e.g. parent, change,
change, parent::

    python3 tools/attention_rows.py ../parent
    python3 tools/attention_rows.py .
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

KEYS = ("case", "ms", "event_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose chip_smoke.py and src/ to run")
    root = Path(ap.parse_args().root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_rows: no CUDA device")
    import chip_smoke

    chip_smoke.phase_build()
    _, decode_rows = chip_smoke.phase_attention(torch)
    for row in decode_rows:
        if "ms" in row:
            print("ROW " + json.dumps({"tree": str(root), **{k: row.get(k) for k in KEYS}}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
