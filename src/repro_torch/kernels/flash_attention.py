"""Causal / sliding-window GQA attention (prefill) on the card.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:flash_attention_fwd``.
The CUDA source is ``csrc/flash_attention.cu``, built by ``_build`` with
``nvcc`` for ``sm_90a`` and called through ``ctypes``. Its entry point
dispatches by dtype, and the source says how each kernel is laid out:

* bfloat16 runs on the tensor cores (``wgmma``, with Q and each K/V tile
  brought in by TMA through a ring of shared-memory stages; at head width
  256 the K/V tiles are 64 rows and a producer warpgroup hands its registers
  to the consumers). A long prompt
  is bound by operations there, the serving prefill by bytes. P is rounded
  to bf16 for the P·V product, which adds at most about 2^-9·max|v| to an
  output, inside the bf16 tolerance;
* float32 runs on the f32 SIMT pipes: on the tensor cores it would be TF32
  and miss the f32 tolerance.

Dispatch goes by the tensor's device: a CPU tensor takes the plain version
(``ref.flash_attention_ref``); a CUDA tensor launches a kernel, or the call
raises. ``launches`` counts kernel launches and nothing else; ``tc_launches``
counts the bf16 ones, which go to the tensor-core kernel. Like the TPU
kernel it is forward-only: called with grad enabled on a tensor that
requires grad, it raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..core.spec import RawArrayError
from . import _build, ref

#: tensor dtype -> the kernels' ``dtype`` argument
DTYPES = {torch.float32: 0, torch.bfloat16: 2}
#: head widths the CUDA kernels are instantiated for
HEAD_DIMS = (32, 64, 128, 256)

_count_lock = threading.Lock()
launches = 0  # guarded-by: _count_lock
tc_launches = 0  # guarded-by: _count_lock

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]


def check_inputs(name: str, *tensors: torch.Tensor) -> None:
    """The checks both attention kernels share: one dtype and device, dense
    tensors, forward only; on the card also a kernel dtype, a supported
    head width and 16-byte aligned storage."""
    first = tensors[0]
    for t in tensors:
        if t.dtype != first.dtype:
            raise RawArrayError(f"{name}: mixed dtypes {first.dtype} and {t.dtype}")
        if t.device != first.device:
            raise RawArrayError(f"{name}: tensors on {first.device} and {t.device}")
        if not t.is_contiguous():
            raise RawArrayError(f"{name} takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RawArrayError(
            f"{name} is forward-only (the TPU kernel has no backward); "
            "call it under torch.no_grad() or torch.inference_mode()"
        )
    if first.device.type == "cpu":
        return
    if first.device.type != "cuda":
        raise RawArrayError(f"{name} runs on cpu or cuda tensors, not {first.device}")
    if first.dtype not in DTYPES:
        raise RawArrayError(f"{name} kernel takes float32 or bfloat16, not {first.dtype}")
    hd = int(first.shape[-1])
    if hd not in HEAD_DIMS:
        raise RawArrayError(f"{name} kernel supports head_dim in {HEAD_DIMS}, not {hd}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise RawArrayError(f"{name} kernel needs 16-byte aligned tensors")


def flash_attention_fwd(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, KV, Sk, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, H, Sq, hd) in q's dtype; q head h attends KV head ``h // (H // KV)``.
    On CUDA the kernel runs on the current stream and is not waited for."""
    global launches, tc_launches
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise RawArrayError(
            f"flash_attention takes q (B,H,Sq,hd) and k, v (B,KV,Sk,hd); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, Sq, hd = (int(d) for d in q.shape)
    KV, Sk = int(k.shape[1]), int(k.shape[2])
    if int(k.shape[0]) != B or int(k.shape[3]) != hd or KV == 0 or H % KV:
        raise RawArrayError(
            f"flash_attention: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}"
        )
    check_inputs("flash_attention", q, k, v)
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention.cu", "flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Sk, hd, DTYPES[q.dtype], int(bool(causal)), int(window), scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"flash_attention kernel launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
        if q.dtype == torch.bfloat16:
            tc_launches += 1
    return out
