"""u8 -> float dequantize (``q * scale + bias`` over the last axis) on the card.

Replaces the TPU kernel ``src/repro/kernels/dequant_u8.py:dequant_u8_fwd``.
The CUDA source is ``csrc/dequant_u8.cu``, built by ``_build`` with ``nvcc``
for ``sm_90a`` and called through ``ctypes``.

What bounds it on the card: bytes. Each element is one byte read and 2-8
bytes written, with no reuse, so the least time is ``(n + n * out_bytes) /
3.35 TB/s`` on an H100 SXM. The design moves those bytes in 16-byte units:
the input is treated as one flat array (a row of C = 3 image channels would
be a 3-byte tile), each thread loads 16 codes as one vector and writes its
16 outputs with vector stores, and a scalar path takes the tail and any
misaligned pointer.

Dispatch goes by the tensor's device: a CPU tensor takes the plain version
(``ref.dequant_u8_ref``); a CUDA tensor launches the kernel, or the call
raises. ``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..core.spec import RawArrayError
from . import _build, ref

#: output dtype -> the kernel's ``out_kind`` argument
OUT_KINDS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.float64: 3}

_count_lock = threading.Lock()
launches = 0  # guarded-by: _count_lock
_launch_fn = None  # guarded-by: _count_lock


def _kernel():
    global _launch_fn
    with _count_lock:
        if _launch_fn is None:
            fn = _build.load("dequant_u8.cu").dequant_u8_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _launch_fn = fn
        return _launch_fn


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, out_dtype) -> int:
    if x.dtype != torch.uint8:
        raise RawArrayError(f"dequant_u8 takes uint8 codes, got {x.dtype}")
    if x.dim() < 1:
        raise RawArrayError("dequant_u8 needs a channel (last) axis; got a 0-d tensor")
    if not x.is_contiguous():
        raise RawArrayError("dequant_u8 takes a contiguous tensor")
    C = int(x.shape[-1])
    for name, p in (("scale", scale), ("bias", bias)):
        if p.dtype != torch.float32 or tuple(p.shape) != (C,):
            raise RawArrayError(
                f"dequant_u8: {name} must be float32 of shape ({C},), "
                f"got {p.dtype} {tuple(p.shape)}"
            )
        if p.device != x.device:
            raise RawArrayError(
                f"dequant_u8: {name} is on {p.device}, codes are on {x.device}"
            )
        if not p.is_contiguous():
            raise RawArrayError(f"dequant_u8: {name} must be contiguous")
    if out_dtype not in OUT_KINDS:
        raise RawArrayError(
            f"dequant_u8 writes float32, float16, bfloat16 or float64, not {out_dtype}"
        )
    return C


def dequant_u8_fwd(
    x: torch.Tensor,      # (..., C) uint8, contiguous
    scale: torch.Tensor,  # (C,) float32 per-channel scale
    bias: torch.Tensor,   # (C,) float32
    *,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``(x * scale + bias)`` rounded to ``out_dtype``, same shape as ``x``.
    On CUDA the kernel runs on the current stream and is not waited for."""
    global launches
    C = _check(x, scale, bias, out_dtype)
    if x.device.type == "cpu":
        return ref.dequant_u8_ref(x, scale, bias, out_dtype)
    if x.device.type != "cuda":
        raise RawArrayError(f"dequant_u8 runs on cpu or cuda tensors, not {x.device}")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            x.numel(), C, OUT_KINDS[out_dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"dequant_u8 kernel launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
    return out
