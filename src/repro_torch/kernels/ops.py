"""Public wrappers for the package's kernels, with the JAX package's names
and signatures (``repro.kernels.ops``).

Every wrapper dispatches by the device of the tensor it is given: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel or the call raises. There is no fallback from one to
the other. ``flash_attention`` and ``ssd_scan`` are differentiable (their
backwards are kernels too; the JAX package leaves both to XLA);
``decode_attention`` is forward-only, as its TPU kernel is, and raises
under grad.
"""

from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attention_fwd
from .dequant_u8 import dequant_u8_fwd
from .flash_attention import flash_attention as _flash_attention
from .ssd_scan import ssd_scan as _ssd_scan


def dequant_u8(x, scale, bias, *, out_dtype=torch.float32, block_rows: int = 256):
    """x (..., C) uint8 -> (..., C) float, ``(x*scale + bias)``.

    ``block_rows`` is accepted for signature parity with the JAX package and
    not used: the CUDA kernel's launch geometry is its own (groups of codes
    whose outputs fill one 16-byte store, a grid sized to the card and to
    the channels' period: ``dequant_u8.geometry``)."""
    del block_rows
    return dequant_u8_fwd(x, scale, bias, out_dtype=out_dtype)


def dequant_rows(x, scale, bias, *, out_dtype=torch.float32, block_rows: Optional[int] = None):
    """``dequant_u8`` as the device feed calls it (and the cold start will).
    ``block_rows`` sized the TPU grid in the JAX package; here it is accepted
    and not used, as in ``dequant_u8``."""
    del block_rows
    return dequant_u8_fwd(x, scale, bias, out_dtype=out_dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128):
    """q (B,H,Sq,dk), k (B,KV,Sk,dk), v (B,KV,Sk,dv) -> (B,H,Sq,dv). GQA via
    KV broadcast; the scale is dk^-1/2.

    ``block_q``/``block_k`` sized the TPU grid; here they are accepted for
    parity and not used: the CUDA kernels' tiles are their own (bf16 on the
    tensor cores: 128 q rows, 128 k rows, 64 at head width 256; f32 on the
    SIMT pipes: 64 q rows, 32 at head width 256, and 32 k rows), and they
    mask a ragged tail themselves. Width pairs: ``flash_attention.HEAD_DIMS``.

    With grad enabled and an input that requires it, the call records its
    backward: ``csrc/flash_attention_bwd.cu`` on the card (f32 at head
    widths 32-128, bf16 at 32-256, any Sq and Sk)."""
    del block_q, block_k
    return _flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, pos, *, window: int = 0, block_s: int = 512,
                     scale: Optional[float] = None, kv_start: int = 0, return_lse: bool = False):
    """q (B,H,dk) with H = KV*group, k (B,KV,S,dk), v (B,KV,S,dv) -> (B,H,dv).

    ``pos`` (rows ``<= pos`` live) may be an int or a one-element int32
    tensor; on the card, pass it on the card so the step needs no host
    sync. ``scale`` defaults to dk^-1/2 (MLA's absorbed decode passes
    (nope + rope)^-1/2, its expanded heads' width, with ``v = k[..., :r]``,
    the latent columns of the cache rows). ``block_s`` is accepted for
    parity and not used: on the card a call is one kernel launch whose S
    splits (a thread block cluster of 1 to 8 CTAs,
    ``decode_attention.geometry``) are sized to the card and stream K/V
    through tiles of their own.

    ``k``/``v`` may be one slice of a longer cache, whose row 0 is position
    ``kv_start`` (``pos`` and ``window`` global); ``return_lse`` gives
    ``(out, lse)``: the slice's normalized partial (B,H,dv) in f32 and each
    head's log-sum-exp (B,H), for ``ref.combine_partials``."""
    del block_s
    B, H, dk = q.shape
    KV = k.shape[1]
    out = decode_attention_fwd(q.reshape(B, KV, H // KV, dk), k, v, pos, window=window,
                               scale=scale, kv_start=kv_start, return_lse=return_lse)
    if return_lse:
        out, lse = out
        return out.reshape(B, H, out.shape[-1]), lse.reshape(B, H)
    return out.reshape(B, H, out.shape[-1])


def ssd_scan(x, dtA, Bm, Cm, *, chunk: int = 128, return_state: bool = False):
    """x (B,H,L,P), dtA (B,H,L), Bm/Cm (B,L,N) -> y (B,H,L,P).

    The chunk is ``min(chunk, L)``, and L must be a multiple of it. With
    ``return_state`` also the final state (B,H,P,N) in float32, which the
    TPU kernel keeps in its scratch after the last chunk and the model's
    prefill needs. On the card bf16 runs on the tensor cores (two kernels:
    ``C·Bᵀ`` once per batch and chunk, then the scan) and float32 on the
    SIMT pipes (one kernel).

    With grad enabled and an input that requires it, the call records its
    backward: ``csrc/ssd_scan_bwd.cu`` on the card (f32 on the SIMT pipes at
    both dtypes, P in ``ssd_scan.BWD_HEAD_DIMS``, N in
    ``ssd_scan.BWD_STATE_DIMS``), the plain scan under autograd on the CPU.
    The final state has no backward: ``return_state`` under grad raises."""
    L = int(x.shape[2])
    return _ssd_scan(x, dtA, Bm, Cm, chunk=max(1, min(chunk, L)), return_state=return_state)
