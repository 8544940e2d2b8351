"""Wall time of a decode step at full size, for comparing two trees of the
port on one card: the decode paths are host-bound, so what a change adds to
the Python of a step shows here first.

For each arch: random weights from a seed, an empty cache of 8 rows and 576
positions, ``WARM`` decode steps, then ``ROUNDS`` rounds of ``STEPS`` steps
fed the argmax of the last logits (as a decode loop feeds them), synchronized
at each round's end. Prints one JSON line an arch with the wall ms a step of
each round and their median, then the card's name and power limit.

With ``--profile``, one more round of ``TRACED`` steps under
``torch.profiler`` (after a one-step trace that warms it): device ms a step
(the summed kernel durations), kernels a step and the share of the wall time
the card had no kernel running. With ``--split`` (a tree whose model serves
through the Megatron split), the same rounds again through
``steps.make_prefill_step``/``make_decode_step`` on a one-rank NCCL mesh,
after a ``PROMPT``-token prefill into a cache of ``CAPACITY`` positions.

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
WARM, STEPS, ROUNDS, TRACED, PROMPT = 4, 32, 3, 8, 256


def _rounds(torch, step, cache, tokens, profile: bool) -> dict:
    """``WARM`` steps of ``step(cache, tokens) -> (logits, cache)``, then
    ``ROUNDS`` timed rounds of ``STEPS``, then (``profile``) a traced one."""
    for _ in range(WARM):
        logits, cache = step(cache, tokens)
        tokens = logits.argmax(-1, keepdim=True)
    rounds = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            logits, cache = step(cache, tokens)
            tokens = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / STEPS * 1e3)
    out = {"wall_ms_per_step": rounds, "median_ms_per_step": statistics.median(rounds)}
    if profile:
        from torch.profiler import ProfilerActivity, profile as trace

        for n in (1, TRACED):  # the first trace warms the profiler
            torch.cuda.synchronize()
            with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    logits, cache = step(cache, tokens)
                    tokens = logits.argmax(-1, keepdim=True)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        out["traced"] = {"steps": TRACED, "wall_ms_per_step": wall_ms / TRACED,
                         "device_ms_per_step": device_ms / TRACED,
                         "kernels_per_step": len(kernels) / TRACED,
                         "device_idle_share": max(0.0, 1 - device_ms / wall_ms)}
    return out


def _split_step(torch, model):
    """(the split decode step, its cache after a ``PROMPT``-token prefill, the
    first tokens) on a one-rank NCCL mesh; the model's weights become the
    mesh's blocks."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeSpec

    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    prefill, (ppl, _), _, _ = steps.make_prefill_step(
        model, mesh, ShapeSpec("prefill", "prefill", PROMPT, BATCH), capacity=CAPACITY)
    decode, _, _, _ = steps.make_decode_step(
        model, mesh, ShapeSpec("decode", "decode", CAPACITY, BATCH))
    steps.shard_model(model, mesh, ppl)
    prompt = np.random.default_rng(0).integers(1, model.cfg.vocab, (BATCH, PROMPT))
    logits, cache = prefill(model.param_tree(), {"tokens": torch.from_numpy(prompt)})
    tokens = logits.to_local().argmax(-1, keepdim=True)

    def step(cache, tokens):
        logits, cache = decode(model.param_tree(), cache, tokens)
        return logits.to_local(), cache

    return step, cache, tokens


def time_arch(arch: str, profile: bool = False, split: bool = False) -> dict:
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    model = build_model(cfg, device=dev, seed=0)
    cache = model.empty_cache(BATCH, CAPACITY)
    tokens = torch.ones((BATCH, 1), dtype=torch.long, device=dev)
    out = {"arch": arch, "tree": repro_torch.__file__, "batch": BATCH, "steps": STEPS,
           **_rounds(torch, model.decode_step, cache, tokens, profile)}
    del cache
    if split:
        out["split"] = _rounds(torch, *_split_step(torch, model), profile)
    del model
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--profile", action="store_true", help="also trace a round")
    ap.add_argument("--split", action="store_true",
                    help="also time the split steps on a one-rank NCCL mesh")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_host_time: no CUDA device")
    with torch.inference_mode():
        for arch in args.arch:
            print(json.dumps(time_arch(arch, args.profile, args.split)), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
