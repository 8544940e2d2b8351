"""GQA decode attention (one query per sequence against the KV cache) on the card.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:decode_attention_fwd``.
The CUDA source is ``csrc/decode_attention.cu``, built by ``_build`` with
``nvcc`` for ``sm_90a`` and called through ``ctypes``.

What bounds it on the card: bytes. Each live K/V row is read once for the
``g`` query heads of its group, so the least time is the live cache bytes
over 3.35 TB/s. The kernel splits the cache along S so that a small batch
still fills the card, and folds the splits' partial softmax states in a
second small kernel (both are one launch of this wrapper).

``pos`` (cache rows ``<= pos`` are live) stays on the device: the wrapper
takes a 0-d or one-element int32 CUDA tensor and hands the kernel its
pointer, so a decode step needs no host sync. A Python int is accepted and
written to the device first.

Dispatch goes by the tensor's device: a CPU tensor takes the plain version
(``ref.decode_attention_ref``); a CUDA tensor launches the kernel, or the
call raises. ``launches`` counts kernel launches and nothing else.
Forward-only, as ``flash_attention``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..core.spec import RawArrayError
from . import _build, ref
from .flash_attention import DTYPES, check_inputs

_count_lock = threading.Lock()
launches = 0  # guarded-by: _count_lock

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_MIN_CHUNK = 64  # keys per split, at least


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return int(torch.cuda.get_device_properties(index).multi_processor_count)


def heads_per_block(g: int) -> int:
    """Query heads one block serves: the largest of 8, 4, 2, 1 dividing g
    (the kernel is instantiated for those)."""
    return next(c for c in (8, 4, 2, 1) if g % c == 0)


def splits(B: int, KV: int, g: int, S: int, sms: int) -> tuple:
    """``(chunk, nsplit)``: enough S splits for about four blocks per SM,
    each of at least ``_MIN_CHUNK`` keys. Fixed by the shapes, not by pos."""
    per_split = B * KV * (g // heads_per_block(g))
    want = max(1, -(-4 * sms // max(per_split, 1)))
    nsplit = max(1, min(want, -(-S // _MIN_CHUNK)))
    chunk = -(-S // nsplit)
    return chunk, -(-S // chunk)


def decode_attention_fwd(
    q: torch.Tensor,  # (B, KV, g, hd)
    k: torch.Tensor,  # (B, KV, S, hd)
    v: torch.Tensor,
    pos,              # int, or 0-d / (1,) int32 tensor: rows <= pos are live
    *,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, KV, g, hd) in q's dtype. On CUDA the kernels run on the current
    stream and are not waited for."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise RawArrayError(
            f"decode_attention takes q (B,KV,g,hd) and k, v (B,KV,S,hd); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, KV, g, hd = (int(d) for d in q.shape)
    S = int(k.shape[2])
    if tuple(k.shape[:2]) != (B, KV) or int(k.shape[3]) != hd:
        raise RawArrayError(
            f"decode_attention: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}"
        )
    check_inputs("decode_attention", q, k, v)
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, pos, window=window, scale=scale)
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.numel() != 1 or pos.device != q.device:
            raise RawArrayError(
                f"decode_attention: pos must be one int32 on {q.device}, got "
                f"{pos.dtype} {tuple(pos.shape)} on {pos.device}"
            )
        pos = pos.contiguous()
    else:
        pos = torch.full((1,), int(pos), dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if S == 0:
        return out.zero_()
    chunk, nsplit = splits(B, KV, g, S, _sm_count(q.device.index or 0))
    part_acc = torch.empty(B * KV * g * nsplit * hd, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(B * KV * g * nsplit * 2, dtype=torch.float32, device=q.device)
    fn = _build.function("decode_attention.cu", "decode_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(),
            B, KV, g, S, hd, DTYPES[q.dtype], int(window), scale, chunk, nsplit,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"decode_attention kernel launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
    return out
