"""End to end on the PyTorch port: train the paper-scale LM on a
RawArray token dataset, with checkpoints, kill-resume, and loader-state
fidelity. The twin of ``examples/train_lm.py``, standing on
``repro_torch.launch.train``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300   # resumes at 200
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 30

The point being demonstrated is the PAPER's: the whole data plane — training
shards, checkpoints — rides on .ra files (mmap reads, atomic archival
writes), and the loader never starves the step function.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "ra_train_lm_torch"))
    p.add_argument("--arch", default="paper_lm")
    p.add_argument("--fresh", action="store_true", help="ignore existing checkpoints")
    p.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data import RaDataset, make_token_dataset
    from repro_torch.launch.train import parse_args, run

    cfg = get_config(args.arch)
    os.makedirs(args.workdir, exist_ok=True)
    ds_root = os.path.join(args.workdir, "dataset")
    if not os.path.exists(os.path.join(ds_root, "manifest.json")):
        print("[data] building RawArray token dataset ...")
        make_token_dataset(ds_root, n_docs=2048, seq_len=min(256, cfg.max_seq), vocab=cfg.vocab)
    ds = RaDataset(ds_root)
    print(f"[data] {len(ds)} docs x {ds.fields['tokens']['shape'][0]} tokens (mmap)")

    cli = ["--arch", args.arch, "--steps", str(args.steps), "--batch", str(args.batch),
           "--workdir", args.workdir, "--dataset", ds_root, "--lr", "1e-3",
           "--ckpt-every", "50", "--seed", "0"]
    if args.fresh:
        cli.append("--fresh")
    if args.device:
        cli += ["--device", args.device]
    out = run(parse_args(cli))

    losses = out["losses"]
    if losses:
        k = max(1, len(losses) // 10)
        first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
        print(
            f"[done] steps={out['steps']} loss {first:.3f} -> {last:.3f} "
            f"({out['wall_s']:.1f}s, stragglers={out['stragglers']})"
        )
        print(f"[loader] {out['loader_stats']}")
        print(f"[ckpt] async save total {out['ckpt_save_s']:.2f}s")


if __name__ == "__main__":
    main()
