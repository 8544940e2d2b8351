"""chip_smoke.py's phases 12 (remote) and 13 (data mesh) alone, for the
checkout given, after the phases whose output they read (4's dataset, 5's
checkpoints), which run untimed: their seconds, to A/B two trees in one call
on the card.

    python3 tools/phase_ab.py PARENT_CHECKOUT; python3 tools/phase_ab.py CHECKOUT
    (then the same two again in the reverse order)

Prints one line ``AB {"tree": ..., "phase_remote": s, "phase_data_mesh": s}``
and the card's name and power limit.
"""
import json
import sys
import tempfile
import time
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(root), str(root / "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

card = cs.phase_environment(torch)
cs.phase_build()
out = {}
with tempfile.TemporaryDirectory(prefix="ab_keep_") as keep:
    runs = cs.phase_main_path(torch, keep)
    torch.cuda.empty_cache()
    serve = cs.phase_serving(torch, keep)
    torch.cuda.empty_cache()
    for name, fn, args in (("phase_remote", cs.phase_remote, (keep, serve, runs)),
                           ("phase_data_mesh", cs.phase_data_mesh, (keep, runs))):
        t0 = time.perf_counter()
        fn(torch, *args)
        out[name] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
print("AB " + json.dumps({"tree": str(root), **out}), card)
