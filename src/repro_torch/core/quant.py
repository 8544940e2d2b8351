"""Typed quantized-field metadata: the paper's user-metadata extension
point carrying dequantization parameters (DESIGN.md §12).

A quantized RawArray file stores a uint8 payload plus a small JSON object
in the trailing user metadata describing how to reconstruct the original
floating-point values::

    {"ra_quant": {"mode": "u8", "scale": [...], "bias": [...],
                  "orig_dtype": "float32", "axis": -1}}

``scale``/``bias`` are either scalars or one value per channel of the LAST
axis, and reconstruction is the affine map ``x ≈ q * scale + bias``
computed in float32 as a separate multiply and add — exactly what the
CUDA kernel (``repro_torch.kernels.ops.dequant_u8``) evaluates on device
(``__fmul_rn`` then ``__fadd_rn``, no fused multiply-add), so the host
(numpy) and device decode paths agree bit for bit.

The schema is deliberately tiny and self-contained: any RawArray reader
that understands JSON can decode a quantized file, and readers that don't
look at metadata still get a well-formed uint8 array — the backward-
compatible extension path the paper advertises for its metadata segment.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from .spec import RawArrayError

# the metadata key the schema lives under (shared with dataset manifests)
QUANT_KEY = "ra_quant"

_MODES = {"u8"}


@dataclass
class QuantInfo:
    """Dequantization parameters for one quantized array/field.

    ``scale`` and ``bias`` are float32 arrays of shape ``()`` (uniform) or
    ``(C,)`` (per-channel over the last axis). ``orig_dtype`` names the
    logical dtype the consumer should see after dequantization.
    """

    mode: str = "u8"
    scale: np.ndarray = field(default_factory=lambda: np.float32(1.0))
    bias: np.ndarray = field(default_factory=lambda: np.float32(0.0))
    orig_dtype: str = "float32"
    axis: int = -1  # channel axis the per-channel params broadcast over

    def __post_init__(self) -> None:
        if self.mode not in _MODES:
            raise RawArrayError(f"unknown quantization mode {self.mode!r}")
        if self.axis != -1:
            raise RawArrayError("only axis=-1 (last-axis channels) is supported")
        self.scale = np.asarray(self.scale, dtype=np.float32)
        self.bias = np.asarray(self.bias, dtype=np.float32)
        if self.scale.ndim > 1 or self.bias.ndim > 1:
            raise RawArrayError("quant scale/bias must be scalar or 1-D per-channel")

    # ---- numpy (host) paths ------------------------------------------------
    def quantize(self, arr: np.ndarray) -> np.ndarray:
        """Float array -> uint8 codes: ``round((x - bias) / scale)`` clipped
        to [0, 255]. Values outside the calibration range saturate."""
        a = np.asarray(arr, dtype=np.float32)
        q = np.rint((a - self.bias) / self.scale)
        return np.clip(q, 0, 255).astype(np.uint8)

    def dequantize(self, q: np.ndarray) -> np.ndarray:
        """uint8 codes -> logical values, float32 math (``q*scale + bias``) —
        the numpy twin of the on-device CUDA kernel."""
        x = q.astype(np.float32) * self.scale + self.bias
        return x.astype(np.dtype(self.orig_dtype), copy=False)

    def channel_params(self, channels: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(scale, bias)`` broadcast to exactly ``(channels,)`` float32 —
        the shape the dequant kernel wants."""
        for name, a in (("scale", self.scale), ("bias", self.bias)):
            if a.ndim == 1 and a.shape[0] not in (1, channels):
                raise RawArrayError(
                    f"per-channel {name} has {a.shape[0]} entries, "
                    f"field has {channels} channels"
                )
        s = np.broadcast_to(self.scale.reshape(-1) if self.scale.ndim else self.scale,
                            (channels,)).astype(np.float32)
        b = np.broadcast_to(self.bias.reshape(-1) if self.bias.ndim else self.bias,
                            (channels,)).astype(np.float32)
        return np.ascontiguousarray(s), np.ascontiguousarray(b)

    # ---- wire format -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        def _num(a: np.ndarray):
            return a.tolist() if a.ndim else float(a)

        return {
            "mode": self.mode,
            "scale": _num(self.scale),
            "bias": _num(self.bias),
            "orig_dtype": self.orig_dtype,
            "axis": self.axis,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuantInfo":
        try:
            return cls(
                mode=str(d["mode"]),
                scale=np.asarray(d["scale"], dtype=np.float32),
                bias=np.asarray(d["bias"], dtype=np.float32),
                orig_dtype=str(d.get("orig_dtype", "float32")),
                axis=int(d.get("axis", -1)),
            )
        except (KeyError, TypeError, ValueError) as e:
            raise RawArrayError(f"malformed {QUANT_KEY} metadata: {d!r}") from e

    def encode(self, extra: Optional[Dict[str, Any]] = None) -> bytes:
        """The metadata blob for a quantized file: a JSON object holding the
        schema under ``"ra_quant"`` (plus any caller keys)."""
        obj = dict(extra or {})
        obj[QUANT_KEY] = self.to_dict()
        return json.dumps(obj).encode()


QuantSpec = Union[str, Tuple[str, float, float], QuantInfo]


def resolve_quant_spec(spec: QuantSpec, dtype="float32") -> QuantInfo:
    """Normalize a user-facing quantize spec into a ``QuantInfo``.

    * ``"u8"``            — uniform range [0, 1] (normalized image pixels,
      the common training-ingest case; out-of-range values saturate);
    * ``("u8", lo, hi)``  — explicit uniform calibration range;
    * a ``QuantInfo``     — taken as-is.

    Streaming writers need the range BEFORE the data arrives, which is why
    the spec is declarative; ``quant_params`` computes a data-driven range
    when the whole array is in hand."""
    if isinstance(spec, QuantInfo):
        return spec
    if isinstance(spec, str):
        mode, lo, hi = spec, 0.0, 1.0
    else:
        mode, lo, hi = spec[0], float(spec[1]), float(spec[2])
    if mode not in _MODES:
        raise RawArrayError(f"unknown quantization mode {mode!r}")
    if not hi > lo:
        raise RawArrayError(f"quant range must have hi > lo, got [{lo}, {hi}]")
    return QuantInfo(
        mode=mode,
        scale=np.float32((hi - lo) / 255.0),
        bias=np.float32(lo),
        orig_dtype=str(np.dtype(dtype)),
    )


def quant_params(arr: np.ndarray, mode: str = "u8") -> QuantInfo:
    """Data-driven calibration: per channel of the LAST axis for ndim >= 2
    (each channel's [min, max] maps onto [0, 255]), one global scalar range
    for 1-D arrays (whose "last axis" is the data itself — per-element
    params would be metadata bigger than the payload). Constant channels
    get ``scale=1`` so they roundtrip exactly through ``bias``."""
    if mode not in _MODES:
        raise RawArrayError(f"unknown quantization mode {mode!r}")
    a = np.asarray(arr)
    if not np.issubdtype(a.dtype, np.floating):
        raise RawArrayError(f"can only quantize float arrays, got {a.dtype}")
    if a.ndim < 1:
        raise RawArrayError("cannot quantize a 0-d array (no channel axis)")
    flat = (a.reshape(-1, 1) if a.ndim == 1 else a.reshape(-1, a.shape[-1]))
    flat = flat.astype(np.float32)
    if flat.size == 0:  # empty array: any affine map roundtrips nothing
        return QuantInfo(mode=mode, scale=np.float32(1.0),
                         bias=np.float32(0.0), orig_dtype=str(a.dtype))
    lo = flat.min(axis=0)
    hi = flat.max(axis=0)
    scale = (hi - lo) / np.float32(255.0)
    scale = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
    if a.ndim == 1:  # scalar params, not one per element
        scale, lo = scale[0], lo[0]
    return QuantInfo(mode=mode, scale=scale, bias=np.asarray(lo, np.float32),
                     orig_dtype=str(a.dtype))


def decode_quant_metadata(meta: Optional[bytes]) -> Optional[QuantInfo]:
    """Parse a RawArray metadata blob; returns the typed ``QuantInfo`` when
    the ``"ra_quant"`` schema is present, ``None`` for any other metadata
    (non-JSON, JSON without the key, empty)."""
    if not meta:
        return None
    try:
        obj = json.loads(meta)
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(obj, dict) or QUANT_KEY not in obj:
        return None
    return QuantInfo.from_dict(obj[QUANT_KEY])
