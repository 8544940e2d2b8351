#!/usr/bin/env python3
"""Which part of the port's attention moves whisper-medium's first-step
attention gradients away from plain attention's, on one CUDA card.

    python3 tools/first_step_probe.py     # from the repository root; needs a card

Builds whisper-medium at full size (random weights from seed 0, attention
tempered as ``chip_smoke.py`` tempers it) and one batch of 8 × (1,500 random
frames + 448 tokens from ``data.synth.markov_tokens``, as phase 16's text),
takes the first step's attention gradients with plain attention, then with
each mix of forward and backward: the kernels' forward and backward, the
kernels' forward with the plain backward, the plain forward with the
kernels' backward, the plain forward with a plain backward rounded where the
kernel rounds (P to bf16 for dV, dS to bf16), and the kernels' backward fed
the O of two other forward designs, emulated in plain PyTorch: O rounded to
bf16 (D from the rounded output) and an f32 O from P rounded to bf16 (no
product of the remainder P − bf16(P)). Prints, for each, the largest
relative difference of a layer's gradient from plain attention's
(``chip_smoke._attention_grad_err``).
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synth import markov_tokens  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def plain_fwd(q, k, v, *, causal=True, window=0, scale=None, return_lse=False):
    o32, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                       return_lse=True, out_dtype=torch.float32)
    return (o32.to(q.dtype), lse, o32) if return_lse else o32.to(q.dtype)


def bf16_out_fwd(q, k, v, *, causal=True, window=0, scale=None, return_lse=False):
    """The plain forward whose output for D is the bf16 one, widened."""
    out = plain_fwd(q, k, v, causal=causal, window=window, scale=scale, return_lse=return_lse)
    return (out[0], out[1], out[0].float()) if return_lse else out


def bf16_p_fwd(q, k, v, *, causal=True, window=0, scale=None, return_lse=False):
    """The plain forward whose f32 output for D is bf16(P)·V: P rounded to
    bf16 for the product, as the kernel's P·V takes it, and no remainder."""
    out = plain_fwd(q, k, v, causal=causal, window=window, scale=scale, return_lse=return_lse)
    if not return_lse:
        return out
    B, H, Sq, hd = q.shape
    g = H // k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    s = q.float() @ kf.transpose(-1, -2) * scale
    ok = ref._live(Sq, k.shape[2], causal, window, q.device)
    p = torch.where(ok, torch.exp(s - out[1][..., None]), torch.zeros((), device=q.device))
    return out[0], out[1], p.bfloat16().float() @ vf


def plain_bwd(q, k, v, out, dout, lse, *, causal=True, window=0, scale=None):
    return ref.flash_attention_bwd_ref(q, k, v, out.float(), dout, lse, causal=causal,
                                       window=window, scale=scale)


def rounded_bwd(q, k, v, out, dout, lse, *, causal=True, window=0, scale=None):
    """The plain backward with the kernel's roundings: P to bf16 for dV, dS to bf16."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    s = qf @ kf.transpose(-1, -2) * scale
    ok = ref._live(Sq, Sk, causal, window, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    d = (dof * out.float()).sum(-1, keepdim=True)
    dv = p.bfloat16().float().transpose(-1, -2) @ dof
    ds = (p * (dof @ vf.transpose(-1, -2) - d)).bfloat16().float()
    dq = ds @ kf * scale
    dk = (ds.transpose(-1, -2) @ qf * scale).reshape(B, KV, g, Sk, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.reshape(B, KV, g, Sk, hd).sum(2).to(v.dtype)


def main() -> int:
    if not torch.cuda.is_available():
        print("first_step_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = get_config("whisper_medium")
    model = build_model(cfg, device=dev, seed=0)
    cs._temper_attention(torch, model)
    model.requires_grad_(True)
    rng = np.random.default_rng(5)
    batch = {"frames": torch.from_numpy(
                 rng.standard_normal((8, cfg.enc_seq, cfg.d_model), dtype=np.float32) * 0.1),
             "tokens": torch.from_numpy(
                 markov_tokens(rng, rng.permutation(cfg.vocab), 8, 448).astype(np.int32))}
    with cs._plain_attention():
        _, _, want = cs._first_step(torch, model, batch)
    kfwd, kbwd = fa.flash_attention_fwd, fa.flash_attention_bwd
    for name, f, b in (("kernel fwd + kernel bwd", kfwd, kbwd),
                       ("kernel fwd + plain bwd", kfwd, plain_bwd),
                       ("plain fwd + kernel bwd", plain_fwd, kbwd),
                       ("plain fwd + plain bwd rounded as the kernel", plain_fwd, rounded_bwd),
                       ("plain fwd, D from the bf16 O + kernel bwd", bf16_out_fwd, kbwd),
                       ("plain fwd, D from an f32 O of bf16 P + kernel bwd", bf16_p_fwd, kbwd)):
        fa.flash_attention_fwd, fa.flash_attention_bwd = f, b
        try:
            _, _, got = cs._first_step(torch, model, batch)
        finally:
            fa.flash_attention_fwd, fa.flash_attention_bwd = kfwd, kbwd
        err = cs._attention_grad_err(torch, got, want)
        print(name, json.dumps({k: round(v["err"], 4) for k, v in err.items()}), flush=True)
        del got
        torch.cuda.empty_cache()
    print(cs.phase_environment(torch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
