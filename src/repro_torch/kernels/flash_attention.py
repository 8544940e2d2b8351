"""Causal / sliding-window GQA attention (prefill and training) on the card.

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

The TPU kernel has no backward; the JAX train step lets XLA differentiate
its own attention. Here ``flash_attention`` is differentiable: with grad on
and an input that requires it, it goes through ``FlashAttention``, an
``autograd.Function`` whose forward runs the kernel above and also keeps
each row's log-sum-exp, and whose backward runs ``csrc/flash_attention_bwd.cu``
(dQ, dK, dV; Sq = Sk; head widths by dtype in ``BWD_HEAD_DIMS``). Its bf16
kernels run on the tensor cores (``wgmma``, tiles brought in by TMA through
a ring of shared-memory stages, head widths up to 256). Under
``no_grad``/``inference_mode`` it calls the forward kernel alone, as
serving does.

Dispatch goes by the tensor's device: a CPU tensor takes the plain versions
(``ref.flash_attention_ref``, ``ref.flash_attention_bwd_ref``); a CUDA tensor
launches a kernel, or the call raises. ``launches`` counts forward kernel
launches and nothing else; ``tc_launches`` counts the bf16 ones, which go to
the tensor-core kernel; ``bwd_launches`` counts backward calls (two kernels
each: dQ, then dK and dV).
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
#: head widths the backward kernels are instantiated for, by dtype: bf16 on the
#: tensor cores takes every forward width, f32 on the SIMT pipes (no model
#: trains there above 128) the first three
BWD_HEAD_DIMS = {torch.float32: (32, 64, 128), torch.bfloat16: HEAD_DIMS}

_count_lock = threading.Lock()
launches = 0  # guarded-by: _count_lock
tc_launches = 0  # guarded-by: _count_lock
bwd_launches = 0  # guarded-by: _count_lock

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_void_p]


def check_forward_only(name: str, *tensors: torch.Tensor) -> None:
    """Raise when ``name`` (a kernel with no backward) is called with grad
    enabled on a tensor that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RawArrayError(
            f"{name} is forward-only (the TPU kernel has no backward); "
            "call it under torch.no_grad() or torch.inference_mode()"
        )


def check_inputs(name: str, *tensors: torch.Tensor) -> None:
    """The checks both attention kernels share: one dtype and device, dense
    tensors; on the card also a kernel dtype, a supported head width and
    16-byte aligned storage."""
    first = tensors[0]
    for t in tensors:
        if t.dtype != first.dtype:
            raise RawArrayError(f"{name}: mixed dtypes {first.dtype} and {t.dtype}")
        if t.device != first.device:
            raise RawArrayError(f"{name}: tensors on {first.device} and {t.device}")
        if not t.is_contiguous():
            raise RawArrayError(f"{name} takes contiguous tensors")
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


def _shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
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
    return B, H, KV, Sq, Sk, hd


def bwd_geometry(S: int, hd: int) -> tuple:
    """The bf16 backward's plan at head width ``hd``, which the launch passes
    to ``csrc/flash_attention_bwd.cu`` (it refuses tiles not its own):
    ``(dq_rows, dq_keys)``, the q rows of a dQ CTA and the keys of each K/V
    tile it walks; ``(kv_keys, kv_rows)``, the keys of a dK/dV CTA and the q
    rows of each (Q, dO) tile it walks; and ``S_pad``, the rows a head of the
    LSE/D scratch, S rounded up to whole dK/dV ring tiles (that kernel
    bulk-copies whole tiles of them)."""
    dq = (128, 32 if hd >= 256 else 128)
    dkdv = (64 if hd >= 256 else 128, 64)
    return dq, dkdv, -(-S // dkdv[1]) * dkdv[1]


def check_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise where the backward cannot run: Sq != Sk, or on the card a dtype
    or head width the backward kernels are not instantiated for."""
    _, _, _, Sq, Sk, hd = _shape(q, k, v)
    if Sq != Sk:
        raise RawArrayError(f"flash_attention backward needs Sq = Sk, got {Sq} and {Sk}")
    if q.device.type != "cuda":
        return
    widths = BWD_HEAD_DIMS.get(q.dtype)
    if widths is None:
        raise RawArrayError(
            f"flash_attention backward kernel takes float32 or bfloat16, not {q.dtype}")
    if hd not in widths:
        raise RawArrayError(
            f"flash_attention backward kernel supports head_dim in {widths} for {q.dtype}, "
            f"not {hd}"
        )


def flash_attention_fwd(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, KV, Sk, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    return_lse: bool = False,
):
    """(B, H, Sq, hd) in q's dtype; q head h attends KV head ``h // (H // KV)``.
    With ``return_lse`` also each row's log-sum-exp (B, H, Sq) in f32, which
    the backward needs. Records no gradient: called with grad on a tensor
    that requires it, it raises (``flash_attention`` is the differentiable
    call). On CUDA the kernel runs on the current stream and is not waited
    for."""
    global launches, tc_launches
    B, H, KV, Sq, Sk, hd = _shape(q, k, v)
    check_inputs("flash_attention", q, k, v)
    check_forward_only("flash_attention_fwd", q, k, v)
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                       return_lse=return_lse)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    fn = _build.function("flash_attention.cu", "flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Sk, hd, DTYPES[q.dtype], int(bool(causal)), int(window), scale,
            lse.data_ptr() if lse is not None else None,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"flash_attention kernel launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
        if q.dtype == torch.bfloat16:
            tc_launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(
    q: torch.Tensor,  # (B, H, S, hd)
    k: torch.Tensor,  # (B, KV, S, hd)
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output (B, H, S, hd)
    dout: torch.Tensor,  # its gradient
    lse: torch.Tensor,  # the forward's log-sum-exp (B, H, S), f32
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
):
    """(dq, dk, dv) of the attention ``flash_attention_fwd`` computes, each in
    its input's dtype; dk and dv summed over each KV head's group of q heads.
    On CUDA two kernels run on the current stream and are not waited for."""
    global bwd_launches
    B, H, KV, Sq, Sk, hd = _shape(q, k, v)
    check_backward(q, k, v)
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(q.shape):
        raise RawArrayError(
            f"flash_attention backward: out {tuple(out.shape)} and dout {tuple(dout.shape)} "
            f"must have q's shape {tuple(q.shape)}"
        )
    check_inputs("flash_attention backward", q, k, v, out, dout)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq) or \
            lse.device != q.device or not lse.is_contiguous():
        raise RawArrayError(
            f"flash_attention backward: lse must be contiguous float32 {(B, H, Sq)} on "
            f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}"
        )
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                                           window=window, scale=scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    dq_tiles, kv_tiles, S_pad = bwd_geometry(Sq, hd)
    # the LSE and D rows the first kernel writes for the second
    delta = torch.empty((B, H, 2, S_pad), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd.cu", "flash_attention_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, KV, Sq, hd, DTYPES[q.dtype], int(bool(causal)), int(window), S_pad,
            *dq_tiles, *kv_tiles, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"flash_attention backward launch failed: cudaError_t {err}")
    with _count_lock:
        bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The attention as an autograd op: the forward kernel, which also keeps
    each row's log-sum-exp, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float | None):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """``flash_attention_fwd``'s output, differentiable in q, k and v: with
    grad enabled and an input that requires it, through ``FlashAttention``
    (a case the backward cannot take raises before the forward runs); else
    the forward kernel alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        check_backward(q, k, v)
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale)
