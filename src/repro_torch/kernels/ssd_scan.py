"""Mamba2's SSD chunked scan (the state-space dual form) on the card.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:ssd_scan_fwd``.
The CUDA source is ``csrc/ssd_scan.cu``, built by ``_build`` with ``nvcc``
for ``sm_90a`` and called through ``ctypes``. Its entry point dispatches by
dtype, and the source says how each kernel is laid out:

* bfloat16 runs on the tensor cores (``mma.sync``) as two kernels, one
  call of this wrapper: the first computes ``C·Bᵀ`` once per (batch,
  chunk) into an f32 scratch the wrapper allocates, shared by every head;
  the second walks the chunks of one (batch, head, state-row tile) in
  order, with the f32 state in the tensor cores' accumulators and the next
  chunk's inputs brought in by TMA while this one computes. Roundings: the
  masked scores ``(C·Bᵀ) ⊙ L`` as two bf16 terms (≲ 2^-17 relative a
  term), the decayed x of the state update in TF32 (≲ 2^-11 a term), the
  state's copy for ``C·stateᵀ`` in bf16 (≲ 2^-9 a term of that product,
  which reaches y only); sums and the carried state stay f32. x, Bm and Cm
  must be 16-byte aligned (TMA reads them);
* float32 runs one kernel on the f32 SIMT pipes, recomputing ``C·Bᵀ``
  for every head: on the tensor cores it would be TF32 and miss the f32
  tolerance.

What bounds it on the card: bytes. Each (batch, head) reads its x and dtA
once, the B and C shared by all heads are read once, and y is written once;
the operations this input needs take less time at the card's peak. One
block walks the chunks of one (batch, head) in order, as the TPU grid's
sequential chunk axis did; when batch × heads is below the SM count the
wrapper splits the head dim P across blocks (``state_split``).

Inputs: x (B,H,L,P) and Bm/Cm (B,L,N) in float32 or bfloat16 (one dtype),
dtA (B,H,L) in any float dtype (float32 is handed to the kernel as it is;
another is widened to it first). y comes back in x's dtype and, with
``return_state``, the final state (B,H,P,N) in float32. ``L % chunk == 0``.

Dispatch goes by the tensor's device: a CPU tensor takes the plain version
(``ref.ssd_scan_ref``); a CUDA tensor launches the kernel, or the call
raises. ``launches`` counts calls that launched (a bf16 call is two
kernels and counts once); ``tc_launches`` counts the bf16 ones, which ran
the tensor-core pair. Like the TPU kernel it is forward-only: called with
grad enabled on a tensor that requires grad, it raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..core.spec import RawArrayError
from . import _build, ref
from .decode_attention import _sm_count
from .flash_attention import DTYPES

#: head dims (P) and state widths (N) the CUDA kernel is instantiated for
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (8, 16, 32, 64, 128)
MAX_CHUNK = 128
_MIN_TILE = 16  # state rows a block owns, at least

_count_lock = threading.Lock()
launches = 0  # guarded-by: _count_lock
tc_launches = 0  # guarded-by: _count_lock

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def state_split(B: int, H: int, P: int, sms: int) -> int:
    """State rows a block owns: P, halved (at most twice) while the doubled
    grid of B·H·(P/tile) blocks still fits in one wave of ``sms`` blocks."""
    tile = P
    while tile // 2 >= _MIN_TILE and B * H * (P // tile) * 2 <= sms and P // tile < 4:
        tile //= 2
    return tile


def _check(x, dtA, Bm, Cm, chunk: int) -> None:
    if x.dim() != 4 or dtA.dim() != 3 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise RawArrayError(
            f"ssd_scan takes x (B,H,L,P), dtA (B,H,L) and Bm, Cm (B,L,N); got "
            f"{tuple(x.shape)}, {tuple(dtA.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, H, L, _ = x.shape
    if tuple(dtA.shape) != (B, H, L) or tuple(Bm.shape[:2]) != (B, L):
        raise RawArrayError(
            f"ssd_scan: x {tuple(x.shape)} does not fit dtA {tuple(dtA.shape)} "
            f"and Bm/Cm {tuple(Bm.shape)}")
    if chunk < 1 or L % chunk:
        raise RawArrayError(f"ssd_scan: L={L} is not a multiple of chunk={chunk}")
    for t in (dtA, Bm, Cm):
        if t.device != x.device:
            raise RawArrayError(f"ssd_scan: tensors on {x.device} and {t.device}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise RawArrayError(f"ssd_scan: x, Bm and Cm must share a dtype, got "
                            f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not dtA.is_floating_point():
        raise RawArrayError(f"ssd_scan: dtA must be floating, not {dtA.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dtA, Bm, Cm)):
        raise RawArrayError(
            "ssd_scan is forward-only (the TPU kernel has no backward); "
            "call it under torch.no_grad() or torch.inference_mode()")


def ssd_scan_fwd(
    x: torch.Tensor,    # (B, H, L, P) inputs already scaled by dt
    dtA: torch.Tensor,  # (B, H, L) per-step log decay
    Bm: torch.Tensor,   # (B, L, N)
    Cm: torch.Tensor,   # (B, L, N)
    *,
    chunk: int = 128,
    return_state: bool = False,
):
    """y (B,H,L,P) in x's dtype, and with ``return_state`` also the final
    state (B,H,P,N) in float32. On CUDA the kernels run on the current stream
    and are not waited for."""
    global launches, tc_launches
    _check(x, dtA, Bm, Cm, chunk)
    if x.device.type == "cpu":
        y, state = ref.ssd_scan_ref(x, dtA, Bm, Cm, chunk=chunk)
        return (y, state) if return_state else y
    if x.device.type != "cuda":
        raise RawArrayError(f"ssd_scan runs on cpu or cuda tensors, not {x.device}")
    B, H, L, P = (int(d) for d in x.shape)
    N = int(Bm.shape[-1])
    if x.dtype not in DTYPES:
        raise RawArrayError(f"ssd_scan kernel takes float32 or bfloat16, not {x.dtype}")
    if P not in HEAD_DIMS or N not in STATE_DIMS or chunk > MAX_CHUNK:
        raise RawArrayError(
            f"ssd_scan kernel supports P in {HEAD_DIMS}, N in {STATE_DIMS} and chunk <= "
            f"{MAX_CHUNK}; got P={P}, N={N}, chunk={chunk}")
    tensor_cores = x.dtype == torch.bfloat16
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise RawArrayError(f"ssd_scan kernel takes a contiguous {name}")
        if tensor_cores and t.data_ptr() % 16:
            raise RawArrayError(f"ssd_scan kernel needs a 16-byte aligned {name}")
    dtA = dtA.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    state = (torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
             if return_state else None)
    if y.numel() == 0:
        return (y, state.zero_()) if return_state else y
    tile = state_split(B, H, P, _sm_count(x.device.index or 0))
    scores = None
    if tensor_cores:  # C·Bᵀ of each (batch, chunk), chunk padded to a multiple of 16
        padded = -(-chunk // 16) * 16
        scores = torch.empty(B * (L // chunk) * padded * padded, dtype=torch.float32,
                             device=x.device)
    fn = _build.function("ssd_scan.cu", "ssd_scan_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), dtA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            state.data_ptr() if state is not None else None,
            scores.data_ptr() if scores is not None else None,
            B, H, L, P, N, int(chunk), tile, DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"ssd_scan kernel launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
        if tensor_cores:
            tc_launches += 1
    return (y, state) if return_state else y
