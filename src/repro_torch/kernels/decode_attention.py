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
call raises. ``launches`` counts kernel launches and nothing else
(``slice_launches`` those of them that take ``kv_start`` or the LSE).
Forward-only, as the TPU kernel: it raises under grad.

A call may attend one slice of a longer cache, the rows a rank holds where
the cache's sequence is split over ranks: ``kv_start`` is the global
position of the slice's row 0 (``pos`` and ``window`` stay global), and
``return_lse`` also returns each head's log-sum-exp, with the output the
slice's normalized partial in f32; ``ref.combine_partials`` (or its
process-group twin in ``distributed/tensor_parallel.py``) merges the
slices' partials. Without either, it is the whole-cache call that the
model's own ``decode_step`` makes.

Head widths come in (q·k, v) pairs (``HEAD_DIMS``). DeepSeek-V3's absorbed
MLA decode attends one latent cache row a token, latent ++ k_rope (576
wide), from all of its query heads, and takes V as the row's first 512
columns: the wrapper takes ``v = k[..., :512]`` and the kernel reads V from
K's tile in shared memory, so the cache crosses from device memory once.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..core.spec import RawArrayError
from . import _build, ref
from .flash_attention import DTYPES, check_forward_only, check_inputs, check_widths

#: (q·k width, v width) pairs the kernel is instantiated for, by dtype. The dense
#: widths and Kimi-K2's 112 read K and V from two caches; (576, 512) is
#: DeepSeek-V3's absorbed MLA decode, which reads V as the first 512 columns of
#: K's rows (latent ++ k_rope): the caller passes ``v = k[..., :512]``
HEAD_DIMS = {
    torch.float32: ((32, 32), (64, 64), (112, 112), (128, 128), (256, 256)),
    torch.bfloat16: ((32, 32), (64, 64), (112, 112), (128, 128), (256, 256), (576, 512)),
}
#: the pairs whose V is K's leading columns, read from K's rows in shared memory
SHARED_ROWS = ((576, 512),)

_count_lock = threading.Lock()
launches = 0  # guarded-by: _count_lock
slice_launches = 0  # guarded-by: _count_lock  (those of them with kv_start or the LSE)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
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


def heads_per_block(g: int, dk: int = 128) -> int:
    """Query heads one block serves: the largest of 8, 4, 2, 1 dividing g
    (the kernel is instantiated for those); at most 2 at a q·k width above
    256 (MLA's 576), where a lane holds 24 query columns a head."""
    return next(c for c in ((8, 4, 2, 1) if dk <= 256 else (2, 1)) if g % c == 0)


def geometry(B: int, KV: int, g: int, S: int, sms: int, dk: int = 128) -> tuple:
    """``(cluster, chunk)``: the CTAs that split S for one (b, kv head, head
    chunk), a cluster of 1, 2, 4 or 8, and the keys each takes (CTA r: keys
    ``[r*chunk, (r+1)*chunk)``). A CTA streams its keys through a deep ring
    with eight consumer warps, so the plan is one full wave of one CTA an SM:
    the largest cluster with B·KV·(g/G)·cluster <= ``sms`` (``sms -
    _CLUSTER_SMS_LOST`` for clusters of 4 or 8; no split when B·KV·(g/G)
    already fills the SMs), at least ``_MIN_KEYS`` keys a CTA, and no CTA
    without a key. Fixed by the shapes, not by pos."""
    clusters = B * KV * (g // heads_per_block(g, dk))
    cluster = max(c for c in CLUSTER_SIZES
                  if c == 1 or (clusters * c <= (sms if c <= 2 else sms - _CLUSTER_SMS_LOST)
                                and c * _MIN_KEYS <= S))
    chunk = -(-S // cluster)
    while cluster > 1 and (cluster - 1) * chunk >= S:  # the last CTA would have no key
        cluster //= 2
        chunk = -(-S // cluster)
    return cluster, max(chunk, 1)


def decode_attention_fwd(
    q: torch.Tensor,  # (B, KV, g, dk)
    k: torch.Tensor,  # (B, KV, S, dk)
    v: torch.Tensor,  # (B, KV, S, dv), or k[..., :dv] (MLA: V is K's leading columns)
    pos,              # int, or 0-d / (1,) int32 tensor: rows <= pos are live
    *,
    window: int = 0,
    scale: float | None = None,
    kv_start: int = 0,
    return_lse: bool = False,
):
    """(B, KV, g, dv) in q's dtype; the scale defaults to dk^-1/2. On CUDA the
    kernel runs on the current stream and is not waited for.

    ``k``/``v`` may be one slice of a longer cache whose position
    ``kv_start`` is the slice's row 0; with ``return_lse`` the result is
    ``(out, lse)``: the slice's normalized partial in f32 (0 where no row
    of the slice is live) and each head's log-sum-exp (B, KV, g) in f32
    (-inf there)."""
    global launches, slice_launches
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise RawArrayError(
            f"decode_attention takes q (B,KV,g,dk), k (B,KV,S,dk) and v (B,KV,S,dv); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, KV, g, dk = (int(d) for d in q.shape)
    S, dv = int(k.shape[2]), int(v.shape[3])
    if tuple(k.shape[:2]) != (B, KV) or int(k.shape[3]) != dk:
        raise RawArrayError(
            f"decode_attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)}"
        )
    # v is k's leading columns: a view of k's rows, read from them on the card
    shared = (dv < dk and v.data_ptr() == k.data_ptr() and v.stride() == k.stride())
    check_inputs("decode_attention", q, k, *(() if shared else (v,)))
    check_forward_only("decode_attention", q, k, v)
    scale = float(scale) if scale is not None else dk ** -0.5
    kv_start = int(kv_start)
    if kv_start < 0:
        raise RawArrayError(f"decode_attention: kv_start must be >= 0, got {kv_start}")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, pos, window=window, scale=scale,
                                        kv_start=kv_start, return_lse=return_lse)
    check_widths("decode_attention", q.dtype, dk, dv, HEAD_DIMS)
    if ((dk, dv) in SHARED_ROWS) != shared:
        raise RawArrayError(
            f"decode_attention kernel reads V from K's rows at (q·k, v) widths {SHARED_ROWS} "
            f"and only there: pass v = k[..., :dv] at those, a cache of its own elsewhere; "
            f"got {(dk, dv)} with v {'in' if shared else 'beside'} k"
        )
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.numel() != 1 or pos.device != q.device:
            raise RawArrayError(
                f"decode_attention: pos must be one int32 on {q.device}, got "
                f"{pos.dtype} {tuple(pos.shape)} on {pos.device}"
            )
        pos = pos.contiguous()
    else:
        pos = torch.full((1,), int(pos), dtype=torch.int32, device=q.device)
    out = torch.empty((B, KV, g, dv), dtype=torch.float32 if return_lse else q.dtype,
                      device=q.device)
    lse = (torch.empty((B, KV, g), dtype=torch.float32, device=q.device) if return_lse
           else None)
    if out.numel() == 0 or S == 0:
        out.zero_()
        if lse is not None:
            lse.fill_(float("-inf"))
        return (out, lse) if return_lse else out
    cluster, chunk = geometry(B, KV, g, S, _sm_count(q.device.index or 0), dk)
    fn = _build.function("decode_attention.cu", "decode_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, KV, g, S, dk, dv, DTYPES[q.dtype],
            int(window), kv_start, scale, cluster, chunk,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RawArrayError(f"decode_attention kernel launch failed: cudaError_t {err}")
    with _count_lock:
        launches += 1
        slice_launches += bool(kv_start or return_lse)
    return (out, lse) if return_lse else out
