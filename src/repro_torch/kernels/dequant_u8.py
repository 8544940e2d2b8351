"""u8 -> float dequantize (``q * scale + bias`` over the last axis) on the card.

Replaces the TPU kernel ``src/repro/kernels/dequant_u8.py:dequant_u8_fwd``.
The CUDA source is ``csrc/dequant_u8.cu``, built by ``_build`` with ``nvcc``
for ``sm_90a`` and called through ``ctypes``.

What bounds it on the card: bytes. Each element is one byte read and 2-8
bytes written, with no reuse, so the least time is ``(n + n * out_bytes) /
3.35 TB/s`` on an H100 SXM. The input is one flat array (a row of C = 3
image channels would be a 3-byte tile) cut into groups of ``E = 16 /
out_bytes`` codes, so that a group's outputs are one 16-byte store and a
warp's stores are contiguous. ``geometry`` plans the launch: thread ``t``
takes groups ``t, t + stride, ...`` with ``stride`` a multiple of the
channels' period in groups, so a thread's channels never change and it
reads its scales and biases once, not once per element. A misaligned
pointer takes groups of one code; the last ``n % E`` codes are the first
block's.

Dispatch goes by the tensor's device: a CPU tensor takes the plain version
(``ref.dequant_u8_ref``); a CUDA tensor launches the kernel, or the call
raises. ``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..core.spec import RawArrayError
from . import _build, ref
from .decode_attention import _sm_count

#: output dtype -> the kernel's ``out_kind`` argument
OUT_KINDS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.float64: 3}

_count_lock = threading.Lock()
launches = 0  # guarded-by: _count_lock

_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p,
]
THREADS = 256  # a block's threads (csrc/dequant_u8.cu:kThreads)
MIN_BLOCKS_PER_SM, MAX_BLOCKS_PER_SM = 2, 4
READ_BYTES = 32  # codes a thread loads before it converts any


def group_codes(out_dtype: torch.dtype) -> int:
    """E: the codes of one group, whose outputs fill one 16-byte store."""
    return 16 // (torch.finfo(out_dtype).bits // 8)


def geometry(n: int, C: int, E: int, sms: int) -> tuple:
    """``(blocks, stride)`` for ``n`` codes of ``C`` channels in groups of
    ``E``: a thread takes ``READ_BYTES / E`` groups at a time, the grid has at
    least ``MIN_BLOCKS_PER_SM`` blocks an SM while the work lasts and at most
    ``MAX_BLOCKS_PER_SM``, and a thread for each channel phase. Thread ``t``
    takes groups ``t, t + stride, ...``: ``stride`` is a multiple of the
    period ``C / gcd(C, E)`` (then the channels of a thread's codes are the
    same in every group), or, when one period is longer than the work, the
    grid's threads (at least the groups: one group a thread)."""
    def ceil(a: int, b: int) -> int:
        return -(-a // b)

    groups = n // E
    period = C // math.gcd(C, E)
    blocks = ceil(ceil(groups, READ_BYTES // E), THREADS)
    blocks = max(blocks, min(MIN_BLOCKS_PER_SM * sms, ceil(groups, THREADS)))
    blocks = min(blocks, MAX_BLOCKS_PER_SM * sms)
    blocks = max(blocks, ceil(min(period, groups), THREADS), 1)
    threads = blocks * THREADS
    stride = threads // period * period if threads >= period else threads
    return blocks, stride


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


def launch_plan(x: torch.Tensor, out: torch.Tensor) -> tuple:
    """``(E, blocks, stride)`` of the launch that decodes ``x`` into ``out``:
    groups of ``group_codes`` codes where both pointers allow them (``x``
    aligned to the group, ``out`` to 16 bytes), else of one code."""
    E = group_codes(out.dtype)
    if x.data_ptr() % E or out.data_ptr() % 16:
        E = 1
    return (E, *geometry(x.numel(), int(x.shape[-1]), E, _sm_count(x.device.index or 0)))


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
    E, blocks, stride = launch_plan(x, out)
    fn = _build.function("dequant_u8.cu", "dequant_u8_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            x.numel(), C, OUT_KINDS[out_dtype], int(E > 1), blocks, stride,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"dequant_u8 kernel launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
    return out
