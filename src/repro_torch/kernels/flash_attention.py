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
  output, inside the bf16 tolerance; the training forward (``return_lse``)
  adds a second product with the remainder P − bf16(P), so its f32 output
  carries P to about 2^-16, as the backward's D needs;
* float32 runs on the f32 SIMT pipes: on the tensor cores it would be TF32
  and miss the f32 tolerance.

The TPU kernel has no backward; the JAX train step lets XLA differentiate
its own attention. Here ``flash_attention`` is differentiable: with grad on
and an input that requires it, it goes through ``FlashAttention``, an
``autograd.Function`` whose forward runs the kernel above and also keeps
each row's log-sum-exp and the output in f32 before its rounding (the
backward's D = rowsum(dO ∘ O) needs it: from the rounded O, or from one
whose P was rounded, its error, times the attention-weighted mean key, can
outgrow dQ itself where keys share a large common part, as whisper's
encoder states do), and whose backward runs
``csrc/flash_attention_bwd.cu``
(dQ, dK, dV; any Sq and Sk, as the encoder-decoder's cross-attention needs;
(q·k, v) width pairs by dtype in ``BWD_HEAD_DIMS``). Its bf16
kernels run on the tensor cores (``wgmma``, tiles brought in by TMA through
a ring of shared-memory stages) at every pair the forward takes. Under
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
#: (q·k width, v width) pairs the forward kernels are instantiated for, by
#: dtype: the dense widths, Kimi-K2's 112, and DeepSeek-V3's MLA prefill, whose
#: q and k are 128 + 64 wide and v 128
HEAD_DIMS = {dt: ((32, 32), (64, 64), (112, 112), (128, 128), (192, 128), (256, 256))
             for dt in DTYPES}
#: (q·k width, v width) pairs the backward kernels (and the training forward) are
#: instantiated for, by dtype: bf16 on the tensor cores takes every forward pair,
#: f32 on the SIMT pipes the dense widths up to 128 (no model trains in f32 above)
BWD_HEAD_DIMS = {torch.float32: ((32, 32), (64, 64), (128, 128)),
                 torch.bfloat16: HEAD_DIMS[torch.bfloat16]}

_count_lock = threading.Lock()
launches = 0  # guarded-by: _count_lock
tc_launches = 0  # guarded-by: _count_lock
bwd_launches = 0  # guarded-by: _count_lock

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 15 + [ctypes.c_float, ctypes.c_void_p]


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
    tensors; on the card also a kernel dtype and 16-byte aligned storage
    (``check_widths`` checks the head widths)."""
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
    for t in tensors:
        if t.data_ptr() % 16:
            raise RawArrayError(f"{name} kernel needs 16-byte aligned tensors")


def check_widths(name: str, dtype: torch.dtype, dk: int, dv: int, table: dict) -> None:
    """Raise unless the kernel is instantiated for q·k width ``dk`` and v
    width ``dv`` in ``dtype`` (``table``: dtype -> (dk, dv) pairs)."""
    pairs = table[dtype]
    if (dk, dv) not in pairs:
        raise RawArrayError(f"{name} kernel takes (q·k, v) head widths {pairs} for {dtype}, "
                            f"not {(dk, dv)}")


def _shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise RawArrayError(
            f"flash_attention takes q (B,H,Sq,dk), k (B,KV,Sk,dk) and v (B,KV,Sk,dv); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, Sq, dk = (int(d) for d in q.shape)
    KV, Sk, dv = int(k.shape[1]), int(k.shape[2]), int(v.shape[3])
    if int(k.shape[0]) != B or int(k.shape[3]) != dk or KV == 0 or H % KV:
        raise RawArrayError(
            f"flash_attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)}"
        )
    return B, H, KV, Sq, Sk, dk, dv


def _padded(d: int) -> int:
    """A width as the tensor-core tiles hold it: whole 64-column boxes from
    64 on (``csrc/sm90.cuh:padded``; 112 is held as 128)."""
    return d if d < 64 else -(-d // 64) * 64


def bwd_geometry(Sq: int, dk: int, dv: int) -> tuple:
    """The bf16 backward's plan at (q·k, v) widths ``(dk, dv)`` for ``Sq``
    q rows, which the launch passes to ``csrc/flash_attention_bwd.cu`` (it
    refuses tiles not its own): ``(dq_rows, dq_keys)``, the q rows of a dQ
    CTA and the keys of each K/V tile it walks (fewer where a 2-stage ring of
    128 would not fit beside Q and dO: 64 at (192, 128), 32 at 256);
    ``(kv_keys, kv_rows)``, the keys of a dK/dV CTA (64 where dK and dV of 128
    keys would not fit two warpgroups' registers: padded widths past 256
    together) and the q rows of each (Q, dO) tile it walks; and ``S_pad``, the
    rows a head of the LSE/D scratch, which holds one row a query: Sq rounded
    up to whole dK/dV ring tiles (that kernel bulk-copies whole tiles of
    them)."""
    kp, vp = _padded(dk), _padded(dv)
    split = kp + vp > 256
    dq = (128, 32 if kp >= 256 else 64 if split else 128)
    dkdv = (64 if split else 128, 64)
    return dq, dkdv, -(-Sq // dkdv[1]) * dkdv[1]


def check_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise where the backward cannot run: shapes that do not fit, or on the
    card a dtype or head widths the backward kernels are not instantiated
    for."""
    _, _, _, _, _, dk, dv = _shape(q, k, v)
    if q.device.type == "cuda":
        check_backward_widths(q.dtype, dk, dv)


def check_backward_widths(dtype: torch.dtype, dk: int, dv: int) -> None:
    """Raise unless the backward kernels are instantiated for ``dtype`` at
    (q·k, v) widths ``(dk, dv)`` (``BWD_HEAD_DIMS``)."""
    pairs = BWD_HEAD_DIMS.get(dtype)
    if pairs is None:
        raise RawArrayError(
            f"flash_attention backward kernel takes float32 or bfloat16, not {dtype}")
    if (dk, dv) not in pairs:
        why = ""
        if (dk, dv) in BWD_HEAD_DIMS[torch.bfloat16]:
            why = "; no model trains there in float32 (the bfloat16 kernels take it)"
        raise RawArrayError(
            f"flash_attention backward kernel takes (q·k, v) head widths {pairs} for "
            f"{dtype}, not {(dk, dv)}{why}")


def flash_attention_fwd(
    q: torch.Tensor,  # (B, H, Sq, dk)
    k: torch.Tensor,  # (B, KV, Sk, dk)
    v: torch.Tensor,  # (B, KV, Sk, dv)
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    return_lse: bool = False,
):
    """(B, H, Sq, dv) in q's dtype; q head h attends KV head ``h // (H // KV)``;
    the scale defaults to dk^-1/2. With ``return_lse`` (the training forward) also what the backward needs:
    (out, each row's log-sum-exp (B, H, Sq) in f32, the output in f32 before
    its rounding to q's dtype (for f32 inputs the output itself)). Records no
    gradient: called with grad on a tensor that requires it, it raises
    (``flash_attention`` is the differentiable call). On CUDA the kernel runs
    on the current stream and is not waited for."""
    global launches, tc_launches
    B, H, KV, Sq, Sk, dk, dv = _shape(q, k, v)
    check_inputs("flash_attention", q, k, v)
    check_forward_only("flash_attention_fwd", q, k, v)
    scale = float(scale) if scale is not None else dk ** -0.5
    if q.device.type == "cuda":
        check_widths("flash_attention", q.dtype, dk, dv, HEAD_DIMS)
        if return_lse:  # the training forward is instantiated where the backward is
            check_backward(q, k, v)
    if q.device.type == "cpu":
        got = ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                                      return_lse=return_lse, out_dtype=torch.float32)
        if not return_lse:
            return got.to(q.dtype)
        out32, lse = got
        return out32.to(q.dtype), lse, out32
    out = torch.empty((B, H, Sq, dv), dtype=q.dtype, device=q.device)
    lse = out32 = None
    if return_lse:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out32 = out if q.dtype == torch.float32 else torch.empty(
            out.shape, dtype=torch.float32, device=q.device)
    result = (out, lse, out32) if return_lse else out
    if out.numel() == 0:
        return result
    fn = _build.function("flash_attention.cu", "flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KV, Sq, Sk, dk, dv, DTYPES[q.dtype], int(bool(causal)), int(window), scale,
            lse.data_ptr() if lse is not None else None,
            out32.data_ptr() if out32 is not None and out32 is not out else None,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"flash_attention kernel launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
        if q.dtype == torch.bfloat16:
            tc_launches += 1
    return result


def flash_attention_bwd(
    q: torch.Tensor,  # (B, H, Sq, dk)
    k: torch.Tensor,  # (B, KV, Sk, dk)
    v: torch.Tensor,  # (B, KV, Sk, dv)
    out: torch.Tensor,  # the forward's output (B, H, Sq, dv) in f32 (``return_lse``'s third)
    dout: torch.Tensor,  # its gradient
    lse: torch.Tensor,  # the forward's log-sum-exp (B, H, Sq), f32
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
):
    """(dq, dk, dv) of the attention ``flash_attention_fwd`` computes, each in
    its input's dtype; dk and dv summed over each KV head's group of q heads.
    ``out`` is the output in float32 before its rounding to q's dtype, as
    ``flash_attention_fwd(..., return_lse=True)`` returns it: the kernels
    take D = rowsum(dO ∘ O) from it, and a rounded output would put its
    rounding error into dq and dk, so any other dtype raises. A key that no
    row sees gets zeros; a row that sees no key gives no gradient. On CUDA
    two kernels run on the current stream and are not waited for."""
    global bwd_launches
    B, H, KV, Sq, Sk, hd, dv_w = _shape(q, k, v)
    check_backward(q, k, v)
    if tuple(out.shape) != (B, H, Sq, dv_w) or tuple(dout.shape) != (B, H, Sq, dv_w):
        raise RawArrayError(
            f"flash_attention backward: out {tuple(out.shape)} and dout {tuple(dout.shape)} "
            f"must have q's shape with v's width, {(B, H, Sq, dv_w)}"
        )
    if out.dtype != torch.float32:
        raise RawArrayError(
            f"flash_attention backward: out must be the forward's float32 output, not "
            f"{out.dtype}")
    check_inputs("flash_attention backward", q, k, v, dout)
    if out.device != q.device:
        raise RawArrayError(f"flash_attention backward: out on {out.device}, q on {q.device}")
    check_inputs("flash_attention backward", out)
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
    if q.numel() == 0 or k.numel() == 0:  # no pair to differentiate
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_tiles, kv_tiles, S_pad = bwd_geometry(Sq, hd, dv_w)
    # the LSE and D rows the first kernel writes for the second
    delta = torch.empty((B, H, 2, S_pad), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd.cu", "flash_attention_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, KV, Sq, Sk, hd, dv_w, DTYPES[q.dtype], int(bool(causal)), int(window), S_pad,
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
    each row's log-sum-exp and the output in f32, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float | None):
        out, lse, out32 = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                              scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out32, lse)
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
