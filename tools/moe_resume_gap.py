"""Where the port's and the reference's moe resume runs part, on the CPU.

The port's ``train()`` of the reduced Kimi-K2 for 6 steps, and the
reference's resumed from the port's step-3 checkpoint, as
``tests/test_torch_moe.py``'s resume tests run them, with a checkpoint each
step. Prints both runs' losses and, after the first resumed update (step 4),
how many parameter entries part past 1e-6 of their leaf's largest entry and
how many of those have an int8 ``v`` code of 0 while their ``m`` code is not
(ROADMAP.md §3 fault 10), with the leaves that part most.

    JAX_PLATFORMS=cpu PYTHONPATH=src PYTHONHASHSEED=23 \\
        python tools/moe_resume_gap.py --workdir /tmp/gap            # per-process draw
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/moe_resume_gap.py --fixed-draw ...

``--fixed-draw`` keeps the tests' crc32 draw (``_same_in_every_process``);
without it the reference's init folds Python's salted ``hash`` (fault 5), so
``PYTHONHASHSEED`` picks the draw.
"""

import argparse
import contextlib
import dataclasses
import glob
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402

import repro.core as ra  # noqa: E402
import test_torch_moe as T  # noqa: E402
from repro_torch.data import make_token_dataset  # noqa: E402


def _leaf(step_dir: str, name: str) -> np.ndarray:
    return np.asarray(ra.read(os.path.join(step_dir, name + ".ra"))).ravel()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--fixed-draw", action="store_true")
    args = ap.parse_args()
    shutil.rmtree(args.workdir, ignore_errors=True)
    ds = os.path.join(args.workdir, "ds")
    make_token_dataset(ds, n_docs=48, seq_len=32, vocab=512, shard_rows=48)
    loop = T._moe_loop
    T._moe_loop = lambda *a: dataclasses.replace(loop(*a), ckpt_every=1, keep=10)
    if not args.fixed_draw:
        T._same_in_every_process = contextlib.nullcontext
    port, ref = (os.path.join(args.workdir, n) for n in ("port", "ref"))
    port_losses = T._port_moe_run(ds, port, 6)["losses"]
    os.makedirs(ref)
    shutil.copytree(os.path.join(port, "step_00000003"), os.path.join(ref, "step_00000003"))
    ref_losses = T._jax_moe_run(ds, ref, 6, resume=True)["losses"]
    print("port losses", port_losses)
    print("reference losses from step 3", ref_losses)

    s3, p4, r4 = (os.path.join(d, f"step_{k:08d}") for d, k in ((port, 3), (port, 4), (ref, 4)))
    parted = on_zero_v = 0
    rows = []
    for path in sorted(glob.glob(os.path.join(p4, "param__*.ra"))):
        name = os.path.basename(path)[len("param__"):-len(".ra")]
        before = _leaf(s3, "param__" + name).astype(np.float64)
        a = _leaf(p4, "param__" + name).astype(np.float64)
        b = _leaf(r4, "param__" + name).astype(np.float64)
        v = _leaf(s3, f"opt__v__{name}__q")
        m = _leaf(s3, f"opt__m__{name}__q")
        if v.size != a.size:  # a padded leaf's moments: not compared entry by entry
            continue
        scale = np.abs(before).max()
        gap = np.abs(a - b)
        off = gap > 1e-6 * scale
        zero_v = (v == 0) & (m != 0)
        parted += int(off.sum())
        on_zero_v += int((off & zero_v).sum())
        i = int(gap.argmax())
        rows.append((float(gap[i] / scale), name, bool(zero_v[i]),
                     float(a[i] - before[i]), float(b[i] - before[i])))
    print(f"step 4: {parted} entries part past 1e-6 of their leaf's largest entry; "
          f"{on_zero_v} of them have a v code of 0 and an m code that is not")
    for gap, name, zv, up, ur in sorted(rows, reverse=True)[:6]:
        print(f"  {name}: {gap:.3g} of its largest entry, v code 0: {zv}, "
              f"step-4 move port {up:.6g} reference {ur:.6g}")


if __name__ == "__main__":
    main()
