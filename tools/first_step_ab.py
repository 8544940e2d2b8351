"""InternLM2-1.8B's first train step as ``chip_smoke.py``'s phase 9 takes it,
for one checkout, to hold two trees bit-equal on one card.

The model is built at full size on the card from phase 9's seed, its
attention tempered as phase 9 tempers it; the batch is phase 9's first
(4 × 2,048 tokens of its token dataset). One forward and backward gives the
loss, the global gradient norm and a SHA-256 of every gradient; then one
step of the train loop's ``make_step`` (AdamW at phase 9's settings) from
the initial weights gives its loss, gradient norm and a SHA-256 of every
parameter after it. Prints ``AB {...}``, then the card's name and power
limit. Run the trees alternately from one call, e.g. parent, change,
change, parent::

    python3 tools/first_step_ab.py build/parent
    python3 tools/first_step_ab.py .
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path


def _sha256(torch, tensors: dict) -> str:
    """One SHA-256 over the leaves' names and bytes, in name order."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().flatten().cpu()
        h.update(name.encode())
        h.update(t.view(torch.uint8).numpy())
    return h.hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose chip_smoke.py and src/ to run")
    root = Path(ap.parse_args().root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("first_step_ab: no CUDA device")
    import chip_smoke as cs
    from repro_torch.checkpoint.store import flatten
    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, RaDataset, make_token_dataset
    from repro_torch.distributed import optimizer as optim
    from repro_torch.models import build_model
    from repro_torch.train.loop import make_step

    cs.phase_build()
    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2_1_8b")
    B, S = 4, 2048
    model = build_model(cfg, device=dev, seed=cs.SEED)
    cs._temper_attention(torch, model)
    model.requires_grad_(True)
    with tempfile.TemporaryDirectory(prefix="first_step_ab_") as tmp:
        data = os.path.join(tmp, "tokens")
        make_token_dataset(data, n_docs=64, seq_len=S, vocab=cfg.vocab, seed=3, shard_rows=64)
        host = DataLoader(RaDataset(data), B, seed=cs.SEED)
        batch = {"tokens": torch.from_numpy(np.array(next(host)["tokens"]))}
        host.stop()

    loss, _ = model.train_loss(batch)
    loss.backward()
    params = model.param_tree()
    out = {"tree": str(root), "loss": float(loss.detach()),
           "grad_norm": float(optim.global_norm(optim.tree_map(lambda p: p.grad, params))),
           "grads_sha256": _sha256(torch, {n: p.grad for n, p in
                                           flatten(params, "param").items()})}
    for p in optim.leaves(params):
        p.grad = None
    adamw = optim.AdamWConfig(lr=1e-3, warmup_steps=2)
    _, _, metrics = make_step(model, adamw)(params, optim.init_state(params, adamw), batch)
    out.update({"step_loss": float(metrics["loss"]), "step_grad_norm": float(
        metrics["grad_norm"]), "params_sha256": _sha256(torch, flatten(model.param_tree(),
                                                                       "param"))})
    print("AB " + json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
