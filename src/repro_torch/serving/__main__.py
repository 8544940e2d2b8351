"""Serve a checkpoint with batched decode requests, on the card.

    PYTHONPATH=src python -m repro_torch.serving --arch internlm2_1_8b --random
    PYTHONPATH=src python -m repro_torch.serving --arch mamba2_780m --random
    PYTHONPATH=src python -m repro_torch.serving --arch zamba2_1_2b --random --prompt 256
    PYTHONPATH=src python -m repro_torch.serving --arch llava_next_mistral_7b --random
    PYTHONPATH=src python -m repro_torch.serving --workdir D   # D/ckpt/step_*

The twin of the JAX package's ``examples/serve_lm.py``: restores the newest
checkpoint under ``<workdir>/ckpt`` through the cold start when there is
one (unless ``--random``), else serves random weights from ``--seed``.
The hybrid family (``--arch zamba2_1_2b``) replays each prompt through the
decode step one token at a time, as the JAX package's engine does. The vlm
family (``--arch llava_next_mistral_7b``) serves text-only prompts, as the
JAX package's engine does; ``--arch whisper_medium`` (encdec) raises, since
neither package's engine serves that family.
``--device cpu`` runs the plain PyTorch path on the host.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m repro_torch.serving")
    p.add_argument("--workdir", default=None)
    p.add_argument("--arch", default="paper_lm")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt", type=int, default=16)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None)
    p.add_argument("--random", action="store_true")
    args = p.parse_args(argv)

    from ..checkpoint import latest_step
    from ..configs import get_config
    from ..models import build_model
    from .engine import ServeEngine, check_servable

    cfg = get_config(args.arch)
    # The engine checks too, but only once the model is built; refusing here
    # spares building (or restoring) full-size weights it would not serve.
    check_servable(cfg)
    ckpt_dir = os.path.join(args.workdir, "ckpt") if args.workdir else None
    step = None if args.random or ckpt_dir is None else latest_step(ckpt_dir)
    t0 = time.perf_counter()
    if step is None:
        print("[serve] no checkpoint; random init")
        engine = ServeEngine(build_model(cfg, device=args.device, seed=args.seed))
    else:
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        print(f"[serve] restoring checkpoint {path}")
        engine = ServeEngine(build_model(cfg, device="meta"), checkpoint=path, device=args.device)
    print(f"[serve] weights ready on {engine.device} in {time.perf_counter() - t0:.3f}s")

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab, (args.batch, args.prompt)).astype(np.int32)
    out = engine.generate(prompts, max_new=args.max_new)
    print(f"[serve] generated {out.shape} tokens; sample row: {out[0][:16]}")
    print(f"[serve] throughput: {engine.throughput()}")


if __name__ == "__main__":
    main()
