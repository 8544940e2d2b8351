"""The moe family's engine tokens as ``chip_smoke.py``'s phases 18-19 take
them, for one checkout, to hold two trees' serving bit-equal on one card.

For kimi-k2-1t and deepseek-v3-671b at full widths, cut to the phases'
depths (that checkout's ``MOE_LAYERS``), built on the card from the phases'
seed, the attention tempered by that checkout's ``_temper_attention``:
8 prompts of 512 tokens with 64 greedy new tokens through ``ServeEngine``
(the phases' prompts). Prints ``TOKENS {...}`` with a SHA-256 of each
model's tokens and of its first prefill's logits, the decode kernel's
launches and the slice calls among them, then the card's name and power
limit. Run the trees alternately from one call, e.g. parent, change::

    python3 tools/moe_serving_tokens.py build/parent
    python3 tools/moe_serving_tokens.py .
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def _sha256(torch, t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().flatten().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose chip_smoke.py and src/ to run")
    root = Path(ap.parse_args().root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("moe_serving_tokens: no CUDA device")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine

    cs.phase_build()
    dev = torch.device("cuda", 0)
    out = {"root": str(root)}
    for arch in ("kimi_k2_1t", "deepseek_v3_671b"):
        cfg = get_config(arch).with_(n_layers=cs.MOE_LAYERS[arch])
        model = build_model(cfg, device=dev, seed=cs.SEED)
        cs._temper_attention(torch, model)
        engine = ServeEngine(model)
        prompts = np.random.default_rng(cs.SEED + 7).integers(1, cfg.vocab, (8, 512)).astype(
            np.int32)
        with torch.inference_mode():
            first = model.prefill(torch.from_numpy(prompts.astype("int64")).to(dev))[0]
        decode_attention.launches = decode_attention.slice_launches = 0
        tokens = engine.generate(prompts, max_new=64)
        out[arch] = {"tokens_sha256": _sha256(torch, torch.as_tensor(np.asarray(tokens))),
                     "first_prefill_logits_sha256": _sha256(torch, first),
                     "decode_launches": decode_attention.launches,
                     "slice_launches": decode_attention.slice_launches}
        del engine, model, first
        torch.cuda.empty_cache()
    print("TOKENS " + json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
