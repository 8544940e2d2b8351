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
the tensor-core pair. ``ssd_scan_fwd`` records no gradient (called with
grad enabled on a tensor that requires it, it raises); ``ssd_scan`` is the
differentiable call.

The backward (the JAX package leaves it to XLA's gradient of
``models/mamba.py:ssd_chunked``) is ``csrc/ssd_scan_bwd.cu``, one call of
``ssd_scan_bwd``, P in ``BWD_HEAD_DIMS`` and N in ``BWD_STATE_DIMS``;
``bwd_geometry`` is its plan, the f32 kernels' fields and the bf16 ones'
in ``tc``. It dispatches by dtype:

* bfloat16 runs on the tensor cores (``mma.sync``), four launches: each
  chunk's local state products for every head, in parallel over the chunks
  (TF32, the decayed x and dy rounded to it); their carry across the chunks,
  elementwise (the states and their gradients, f32); each chunk's gradients,
  one block per (chunk, group of ``BWD_GROUP`` heads, batch), which computes
  ``C·Bᵀ`` once for its heads and sums dB and dC over them in its
  accumulators (bf16 products with f32 sums; the f32 (Q, Q) operands as two
  bf16 terms, the states rounded to TF32); and the groups' partials summed
  in order. What bounds it at Mamba2-780M's training shape: operations and
  bytes are close (0.059 and 0.049 ms); the f32 scratch the states and
  their gradients make (written and read back, some 0.9 GB) is most of what
  stands between the kernels and that bound;
* float32 runs three kernels on the f32 SIMT pipes (on the tensor cores it
  would be TF32 and miss the f32 tolerance): the states and their gradients
  per (batch, head), each chunk's gradients per (batch, head, chunk), dB and
  dC summed over the heads from per-head partials.

A bf16 call launches the tensor-core kernels or raises; it never takes the
SIMT ones. Every sum is taken in a fixed order, so two calls give bit-equal
outputs. ``bwd_launches`` counts the backward's calls and
``bwd_tc_launches`` the bf16 ones, which ran the tensor-core kernels. Under
grad, ``ssd_scan`` runs a CUDA tensor through ``SsdScan`` (the forward
kernel, then this backward) and a CPU tensor through the plain scan under
autograd.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Tuple

import torch

from ..core.spec import RawArrayError
from . import _build, ref
from .decode_attention import _sm_count
from .flash_attention import DTYPES

#: head dims (P) and state widths (N) the CUDA kernel is instantiated for
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (8, 16, 32, 64, 128)
#: head dims and state widths the backward kernel is instantiated for
BWD_HEAD_DIMS = (32, 64)
BWD_STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 128
_MIN_TILE = 16  # state rows a block owns, at least
BWD_SLAB = 32  # rows (or columns) of a chunk's (Q, Q) matrices the backward holds at once
BWD_THREADS = 256
BWD_GROUP = 8  # heads a block of the bf16 backward takes (dB and dC summed over them inside)
_CARRY_VEC = 8  # state entries a thread of the bf16 backward's carry owns

_count_lock = threading.Lock()
launches = 0  # guarded-by: _count_lock
tc_launches = 0  # guarded-by: _count_lock
bwd_launches = 0  # guarded-by: _count_lock
bwd_tc_launches = 0  # guarded-by: _count_lock

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


class TcBwdPlan(NamedTuple):
    """The bf16 backward's launch plan (tensor cores; ``bwd_geometry``'s ``tc``)."""

    group: int                          # heads a block takes
    n_groups: int                       # ceil(H / group)
    local_grid: Tuple[int, int, int]    # (n_chunks, n_groups, B): the chunk-local states
    carry_grid: Tuple[int, int, int]    # (slices, H, B): the carry across the chunks
    carry_threads: int
    chunk_grid: Tuple[int, int, int]    # (n_chunks, n_groups, B): each chunk's gradients
    reduce_grid: Tuple[int, int]        # (blocks over B·L·N, 2): dB, then dC
    threads: int
    local_smem: int                     # bytes of shared memory a local block takes
    chunk_smem: int                     # and a chunk block
    states: Tuple[int, ...]             # (B,H,n_chunks,P,N) f32: own_c, then s_c; inject_c, then g_{c+1}
    lam: Tuple[int, ...]                # (B,H,n_chunks) f32: Λ of each chunk
    gs: Tuple[int, ...]                 # (B,H,parts,n_chunks) f32: exp(Λ_c)·Σ(g_{c+1} ⊙ s_c), a part a carry warp
    parts: Tuple[int, ...]              # (B,n_groups,L,N) f32: dB's and dC's partials by group


class BwdPlan(NamedTuple):
    """The backward's launch plan (``bwd_geometry``): the f32 SIMT kernels'
    fields, and the bf16 tensor-core kernels' in ``tc``."""

    n_chunks: int
    scan_grid: Tuple[int, int]          # (H, B): one block a (batch, head)
    chunk_grid: Tuple[int, int, int]    # (n_chunks, H, B): one block a (batch, head, chunk)
    reduce_grid: Tuple[int, int]        # (blocks over B·L·N, 2): dB, then dC
    slab: int
    threads: int
    scan_smem: int                      # bytes of shared memory a scan block takes
    chunk_smem: int                     # and a chunk block
    states: Tuple[int, ...]             # (B,H,n_chunks,P,N) f32: s_c, and g_{c+1}
    gs: Tuple[int, ...]                 # (B,H,n_chunks) f32: exp(Λ_c)·Σ(g_{c+1} ⊙ s_c)
    parts: Tuple[int, ...]              # (B,H,L,N) f32: dB's and dC's per-head partials
    tc: TcBwdPlan


def _tc_bwd_geometry(B: int, H: int, L: int, P: int, N: int, Q: int) -> TcBwdPlan:
    """The bf16 backward's plan (``csrc/ssd_scan_bwd.cu``, namespace tc, whose
    ``LocalSmem`` and ``ChunkSmem`` the launch checks against these). Qp is Q
    rounded up to 16, T = (Qp/16)(Qp/16 + 1)/2 the lower-triangle 16x16 tiles
    of a chunk. local_kernel holds B and C (Qp, N) and x and dy (Qp, P) in bf16
    and three (128) f32 vectors; chunk_kernel the same four slabs, G in f32 and
    D or G ⊙ L as two bf16 terms (T tiles each), the state or its gradient f32
    (P, N + 4), eight (128) f32 vectors and two (T, 16) f32 sums."""
    nc = L // Q
    Qp = -(-Q // 16) * 16
    tiles = (Qp // 16) * (Qp // 16 + 1) // 2
    groups = -(-H // BWD_GROUP)
    carry_threads = min(BWD_THREADS, P * N // _CARRY_VEC)
    slices = P * N // (carry_threads * _CARRY_VEC)
    slabs = 2 * Qp * N * 2 + 2 * Qp * P * 2
    chunk = (slabs + tiles * 256 * 4 + tiles * 256 * 2 * 2 + P * (N + 4) * 4 + 8 * MAX_CHUNK * 4
             + 2 * tiles * 16 * 4)
    return TcBwdPlan(
        group=BWD_GROUP, n_groups=groups, local_grid=(nc, groups, B),
        carry_grid=(slices, H, B), carry_threads=carry_threads, chunk_grid=(nc, groups, B),
        reduce_grid=(-(-(B * L * N) // BWD_THREADS), 2), threads=BWD_THREADS,
        local_smem=slabs + 3 * MAX_CHUNK * 4, chunk_smem=chunk, states=(B, H, nc, P, N),
        lam=(B, H, nc), gs=(B, H, slices * carry_threads // 32, nc), parts=(B, groups, L, N))


def bwd_geometry(B: int, H: int, L: int, P: int, N: int, Q: int) -> BwdPlan:
    """The backward kernels' plan for x (B,H,L,P), B/C (B,L,N) and a chunk of Q
    steps. The f32 fields: grids, slab, threads, the f32 scratch the wrapper
    allocates and the shared memory of each SIMT kernel
    (``csrc/ssd_scan_bwd.cu:Plan``, which the launch checks against these). Qp
    is Q rounded up to the slab: the chunk kernel holds B or C (Qp, N+1), x or
    dy (Qp, P+1), the state or its gradient (P, N+1), a slab of each (32 rows),
    two (Qp, 33) slabs of the (Q, Q) matrices and four (Qp) vectors; the scan
    kernel a chunk's B or C and x or dy, two (Qp) vectors and one float a
    thread. ``tc`` is the bf16 tensor-core kernels' plan (``_tc_bwd_geometry``)."""
    nc = L // Q
    Qp = -(-Q // BWD_SLAB) * BWD_SLAB
    ld_n, ld_p = N + 1, P + 1
    scan = Qp * ld_n + Qp * ld_p + 2 * Qp + BWD_THREADS + 4
    chunk = (Qp * ld_n + Qp * ld_p + P * ld_n + BWD_SLAB * ld_n + BWD_SLAB * ld_p
             + 2 * Qp * (BWD_SLAB + 1) + 4 * Qp + 4)
    return BwdPlan(
        n_chunks=nc, scan_grid=(H, B), chunk_grid=(nc, H, B),
        reduce_grid=(-(-(B * L * N) // BWD_THREADS), 2), slab=BWD_SLAB, threads=BWD_THREADS,
        scan_smem=4 * scan, chunk_smem=4 * chunk, states=(B, H, nc, P, N), gs=(B, H, nc),
        parts=(B, H, L, N), tc=_tc_bwd_geometry(B, H, L, P, N, Q))


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


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    state (B,H,P,N) in float32. Records no gradient: called with grad on a
    tensor that requires it, it raises (``ssd_scan`` is the differentiable
    call). On CUDA the kernels run on the current stream and are not waited
    for."""
    global launches, tc_launches
    _check(x, dtA, Bm, Cm, chunk)
    if _wants_grad(x, dtA, Bm, Cm):
        raise RawArrayError(
            "ssd_scan_fwd records no gradient; call ssd_scan (differentiable), or this "
            "under torch.no_grad() or torch.inference_mode()")
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


def check_backward(x, dtA, Bm, Cm, chunk: int) -> None:
    """Raise where the backward cannot run: shapes that do not fit, or on the
    card a dtype, P, N or chunk the backward kernel is not instantiated for."""
    _check(x, dtA, Bm, Cm, chunk)
    if x.device.type != "cuda":
        return
    P, N = int(x.shape[-1]), int(Bm.shape[-1])
    if x.dtype not in DTYPES:
        raise RawArrayError(f"ssd_scan backward kernel takes float32 or bfloat16, not {x.dtype}")
    if P not in BWD_HEAD_DIMS or N not in BWD_STATE_DIMS or chunk > MAX_CHUNK:
        raise RawArrayError(
            f"ssd_scan backward kernel supports P in {BWD_HEAD_DIMS}, N in {BWD_STATE_DIMS} "
            f"and chunk <= {MAX_CHUNK}; got P={P}, N={N}, chunk={chunk}")


def ssd_scan_bwd(
    x: torch.Tensor,    # (B, H, L, P)
    dtA: torch.Tensor,  # (B, H, L)
    Bm: torch.Tensor,   # (B, L, N)
    Cm: torch.Tensor,   # (B, L, N)
    dy: torch.Tensor,   # (B, H, L, P): the gradient of y
    *,
    chunk: int = 128,
):
    """(dx, d(dtA), dB, dC) of ``ssd_scan_fwd``'s y (the final state takes no
    gradient), each in its input's dtype: dx, dB and dC summed in f32 and
    rounded once, d(dtA) in f32 and then converted. A CPU tensor takes
    ``ref.ssd_scan_bwd_ref``; on CUDA the kernels (bf16: four on the tensor
    cores; f32: three) run on the current stream and are not waited for."""
    global bwd_launches, bwd_tc_launches
    check_backward(x, dtA, Bm, Cm, chunk)
    if tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise RawArrayError(f"ssd_scan backward: dy {tuple(dy.shape)} on {dy.device} must "
                            f"have x's shape {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return ref.ssd_scan_bwd_ref(x, dtA, Bm, Cm, dy, chunk=chunk)
    if x.device.type != "cuda":
        raise RawArrayError(f"ssd_scan runs on cpu or cuda tensors, not {x.device}")
    B, H, L, P = (int(d) for d in x.shape)
    N = int(Bm.shape[-1])
    x, Bm, Cm = (t.contiguous() for t in (x, Bm, Cm))
    dy = dy.to(x.dtype).contiguous()
    a = dtA.to(torch.float32).contiguous()
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    da = torch.empty(a.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, da.to(dtA.dtype), dB.zero_(), dC.zero_()
    plan = bwd_geometry(B, H, L, P, N, chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    tensor_cores = x.dtype == torch.bfloat16
    if tensor_cores:  # cp.async reads 16 bytes a copy: a view at an odd offset is copied
        x, dy, Bm, Cm = (t.clone() if t.data_ptr() % 16 else t for t in (x, dy, Bm, Cm))
        tc = plan.tc
        states, dstates = torch.empty(tc.states, **f32), torch.empty(tc.states, **f32)
        gs, lam = torch.empty(tc.gs, **f32), torch.empty(tc.lam, **f32)
        dbp, dcp = torch.empty(tc.parts, **f32), torch.empty(tc.parts, **f32)
        sizes = (0, tc.group, tc.local_smem, tc.chunk_smem)
    else:
        states, dstates = torch.empty(plan.states, **f32), torch.empty(plan.states, **f32)
        gs, lam = torch.empty(plan.gs, **f32), None
        dbp, dcp = torch.empty(plan.parts, **f32), torch.empty(plan.parts, **f32)
        sizes = (plan.slab, 0, plan.scan_smem, plan.chunk_smem)
    fn = _build.function("ssd_scan_bwd.cu", "ssd_scan_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), dy.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            dx.data_ptr(), da.data_ptr(), dB.data_ptr(), dC.data_ptr(), states.data_ptr(),
            dstates.data_ptr(), gs.data_ptr(), lam.data_ptr() if lam is not None else None,
            dbp.data_ptr(), dcp.data_ptr(), B, H, L, P, N, int(chunk), *sizes,
            DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"ssd_scan backward launch failed: cudaError_t {err}")
    with _count_lock:
        bwd_launches += 1
        if tensor_cores:
            bwd_tc_launches += 1
    return dx, da.to(dtA.dtype), dB, dC


class SsdScan(torch.autograd.Function):
    """The scan as an autograd op: the forward kernel, then the backward
    kernel, which recomputes the chunks' states from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dtA, Bm, Cm, chunk: int):
        y = ssd_scan_fwd(x, dtA, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dtA, Bm, Cm)
        ctx.chunk = chunk
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, dtA, Bm, Cm = ctx.saved_tensors
        dx, ddtA, dB, dC = ssd_scan_bwd(x, dtA, Bm, Cm, dy, chunk=ctx.chunk)
        return dx, ddtA, dB, dC, None


def ssd_scan(x, dtA, Bm, Cm, *, chunk: int = 128, return_state: bool = False):
    """``ssd_scan_fwd``'s output, differentiable in x, dtA, Bm and Cm: with
    grad enabled and an input that requires it, a CUDA tensor goes through
    ``SsdScan`` (a case the backward cannot take raises before the forward
    runs) and a CPU tensor through the plain scan under autograd; else the
    forward kernel alone. The final state has no backward: ``return_state``
    under grad raises."""
    if not _wants_grad(x, dtA, Bm, Cm):
        return ssd_scan_fwd(x, dtA, Bm, Cm, chunk=chunk, return_state=return_state)
    if return_state:
        raise RawArrayError(
            "ssd_scan: the final state has no backward; call with return_state=False "
            "under grad, or under torch.no_grad()")
    check_backward(x, dtA, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dtA, Bm, Cm, chunk=chunk)[0]
    return SsdScan.apply(x, dtA, Bm, Cm, chunk)
