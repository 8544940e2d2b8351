"""GQA decode attention (one query per sequence against the KV cache) on the card.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:decode_attention_fwd``.
The CUDA source is ``csrc/decode_attention.cu``, built by ``_build`` with
``nvcc`` for ``sm_90a`` and called through ``ctypes``.

What bounds it on the card: bytes. Each live K/V row is read once for the
``g`` query heads of its group, so the least time is the live cache bytes
over 3.35 TB/s. One call is one kernel launch with no scratch in device
memory: the S splits of one (batch, kv head, head chunk) form a thread
block cluster (``geometry`` picks its size so that a small batch still fills
the card), K and V stream through a bulk-copy ring in shared memory, and the
splits' partial softmax states fold through distributed shared memory.

``pos`` (cache rows ``<= pos`` are live) stays on the device: the wrapper
takes a 0-d or one-element int32 CUDA tensor and hands the kernel its
pointer, so a decode step needs no host sync. A Python int is accepted and
written to the device first.

Dispatch goes by the tensor's device: a CPU tensor takes the plain version
(``ref.decode_attention_ref``); a CUDA tensor launches the kernel, or the
call raises. ``launches`` counts kernel launches and nothing else.
Forward-only, as the TPU kernel: it raises under grad.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..core.spec import RawArrayError
from . import _build, ref
from .flash_attention import DTYPES, check_forward_only, check_inputs

_count_lock = threading.Lock()
launches = 0  # guarded-by: _count_lock

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
#: cluster sizes the kernel launches with (portable: no opt-in needed)
CLUSTER_SIZES = (1, 2, 4, 8)
_MIN_KEYS = 32  # keys per CTA, at least
# SMs that cannot host a CTA of a cluster of 4 or 8 at once: a cluster lies in one
# GPC, and on an H100 (132 SMs) such clusters reached only 124 SMs; a grid of more
# CTAs ran its last clusters in a second wave (measured, PERF.md §6, PRs 15 and 16)
_CLUSTER_SMS_LOST = 8


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return int(torch.cuda.get_device_properties(index).multi_processor_count)


def heads_per_block(g: int) -> int:
    """Query heads one block serves: the largest of 8, 4, 2, 1 dividing g
    (the kernel is instantiated for those)."""
    return next(c for c in (8, 4, 2, 1) if g % c == 0)


def geometry(B: int, KV: int, g: int, S: int, sms: int) -> tuple:
    """``(cluster, chunk)``: the CTAs that split S for one (b, kv head, head
    chunk), a cluster of 1, 2, 4 or 8, and the keys each takes (CTA r: keys
    ``[r*chunk, (r+1)*chunk)``). A CTA streams its keys through a deep ring
    with eight consumer warps, so the plan is one full wave of one CTA an SM:
    the largest cluster with B·KV·(g/G)·cluster <= ``sms`` (``sms -
    _CLUSTER_SMS_LOST`` for clusters of 4 or 8; no split when B·KV·(g/G)
    already fills the SMs), at least ``_MIN_KEYS`` keys a CTA, and no CTA
    without a key. Fixed by the shapes, not by pos."""
    clusters = B * KV * (g // heads_per_block(g))
    cluster = max(c for c in CLUSTER_SIZES
                  if c == 1 or (clusters * c <= (sms if c <= 2 else sms - _CLUSTER_SMS_LOST)
                                and c * _MIN_KEYS <= S))
    chunk = -(-S // cluster)
    while cluster > 1 and (cluster - 1) * chunk >= S:  # the last CTA would have no key
        cluster //= 2
        chunk = -(-S // cluster)
    return cluster, max(chunk, 1)


def decode_attention_fwd(
    q: torch.Tensor,  # (B, KV, g, hd)
    k: torch.Tensor,  # (B, KV, S, hd)
    v: torch.Tensor,
    pos,              # int, or 0-d / (1,) int32 tensor: rows <= pos are live
    *,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, KV, g, hd) in q's dtype. On CUDA the kernel runs on the current
    stream and is not waited for."""
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
    check_forward_only("decode_attention", q, k, v)
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
    cluster, chunk = geometry(B, KV, g, S, _sm_count(q.device.index or 0))
    fn = _build.function("decode_attention.cu", "decode_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, KV, g, S, hd, DTYPES[q.dtype], int(window), scale, cluster, chunk,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"decode_attention kernel launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
    return out
