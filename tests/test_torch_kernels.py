"""The port's dequant kernel wrappers (``repro_torch.kernels``) against the
JAX package's decode, on the CPU, from the same numpy inputs.

Tolerances:

* exact equality with ``repro.kernels.ref.dequant_u8_ref`` (eager jnp) and
  with numpy ``QuantInfo.dequantize``: all three compute the float32
  ``q*s`` and ``+ b`` as two separately rounded ops, then round once to the
  output dtype (nearest even);
* at most 1 ulp of the output dtype against the Pallas path in interpret
  mode (``repro.kernels.ops.dequant_rows``), compared on the integer bit
  patterns: XLA:CPU contracts the multiply-add of the jitted kernel into an
  FMA, which rounds once instead of twice. Scale and bias are drawn positive
  here, so the sum never cancels and the double rounding stays within one
  ulp of the result.

The CUDA kernel itself runs only on the card: ``tests/test_torch_cuda.py``
launches it (and skips without one), and ``chip_smoke.py`` holds it
against its plain version at the main path's shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as ra
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import QuantInfo as TorchQuantInfo
from repro_torch.core.spec import RawArrayError
from repro_torch.kernels import dequant_u8 as dq
from repro_torch.kernels import ops, ref

_OUT = {"float32": (torch.float32, jnp.float32, np.int32),
        "bfloat16": (torch.bfloat16, jnp.bfloat16, np.int16)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    q = rng.integers(0, 256, shape, dtype=np.uint8)
    scale = (rng.random(C) * 0.02 + 1e-3).astype(np.float32)
    bias = rng.random(C).astype(np.float32)
    return q, scale, bias


def _bits(a, int_dtype):
    """Integer bit pattern of a float array (numpy, ml_dtypes or torch)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
        return a.astype(np.int64)
    return np.asarray(a).view(int_dtype).astype(np.int64)


def _port(q, scale, bias, out, fn=ops.dequant_rows):
    return fn(torch.from_numpy(q), torch.from_numpy(scale), torch.from_numpy(bias),
              out_dtype=_OUT[out][0])


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 3, 128, 130])
@pytest.mark.parametrize("rows", [1, 7, 256, 1000, 4099])
def test_dequant_rows_matches_jax(rows, C, out):
    q, scale, bias = _inputs((rows, C), seed=rows * 1000 + C)
    torch_dt, jax_dt, int_dt = _OUT[out]
    got = _port(q, scale, bias, out)
    assert got.dtype == torch_dt and tuple(got.shape) == (rows, C)

    # exact: eager jnp oracle and numpy host decode
    want_ref = np.asarray(jax_ref.dequant_u8_ref(jnp.asarray(q), jnp.asarray(scale),
                                                 jnp.asarray(bias), jax_dt))
    np.testing.assert_array_equal(_bits(got, int_dt), _bits(want_ref, int_dt))
    if out == "float32":
        host = ra.QuantInfo(scale=scale, bias=bias).dequantize(q)
        np.testing.assert_array_equal(got.numpy(), host)

    # within 1 ulp: the jitted Pallas kernel in interpret mode
    pallas = np.asarray(jax_ops.dequant_rows(jnp.asarray(q), jnp.asarray(scale),
                                             jnp.asarray(bias), out_dtype=jax_dt,
                                             interpret=True))
    ulps = np.abs(_bits(got, int_dt) - _bits(pallas, int_dt))
    assert ulps.max() <= 1, f"{ulps.max()} ulp from the Pallas path"


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_dequant_u8_image_batch_shape(out):
    """(B, 32, 32, 3) codes, as the device feed hands them over: decoded over
    the last axis, shape kept."""
    q, scale, bias = _inputs((4, 32, 32, 3), seed=11)
    torch_dt, jax_dt, int_dt = _OUT[out]
    got = _port(q, scale, bias, out, fn=ops.dequant_u8)
    assert tuple(got.shape) == (4, 32, 32, 3) and got.dtype == torch_dt
    pallas = np.asarray(jax_ops.dequant_u8(jnp.asarray(q), jnp.asarray(scale),
                                           jnp.asarray(bias), out_dtype=jax_dt,
                                           interpret=True))
    assert pallas.shape == q.shape
    assert np.abs(_bits(got, int_dt) - _bits(pallas, int_dt)).max() <= 1
    if out == "float32":
        np.testing.assert_array_equal(
            got.numpy(), ra.QuantInfo(scale=scale, bias=bias).dequantize(q))


def test_port_quantinfo_decode_matches_reference():
    """The port's copy of ``QuantInfo`` decodes exactly as the reference."""
    q, scale, bias = _inputs((300, 24), seed=5)
    np.testing.assert_array_equal(
        TorchQuantInfo(scale=scale, bias=bias).dequantize(q),
        ra.QuantInfo(scale=scale, bias=bias).dequantize(q),
    )


@pytest.mark.parametrize("out", [torch.float16, torch.float64])
def test_dequant_other_float_outputs(out):
    """f16 rounds the f32 result to nearest even; f64 widens it exactly."""
    q, scale, bias = _inputs((64, 5), seed=3)
    got = ops.dequant_rows(torch.from_numpy(q), torch.from_numpy(scale),
                           torch.from_numpy(bias), out_dtype=out)
    f32 = q.astype(np.float32) * scale + bias
    np.testing.assert_array_equal(
        got.numpy(), f32.astype(np.float16 if out == torch.float16 else np.float64))


def test_cpu_path_does_not_count_launches():
    q, scale, bias = _inputs((8, 3), seed=1)
    before = dq.launches
    _port(q, scale, bias, "float32")
    assert dq.launches == before


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((4, 3), dtype=torch.uint8)
    s, b = torch.ones(3), torch.zeros(3)
    with pytest.raises(RawArrayError, match="uint8"):
        ops.dequant_u8(x.float(), s, b)
    with pytest.raises(RawArrayError, match=r"shape \(3,\)"):
        ops.dequant_u8(x, torch.ones(4), b)
    with pytest.raises(RawArrayError, match=r"shape \(3,\)"):
        ops.dequant_u8(x, s, torch.zeros((1, 3)))
    with pytest.raises(RawArrayError, match="float32"):
        ops.dequant_u8(x, s.double(), b)
    with pytest.raises(RawArrayError, match="contiguous"):
        ops.dequant_u8(torch.zeros((3, 4), dtype=torch.uint8).t(), s, b)
    with pytest.raises(RawArrayError, match="writes float32"):
        ops.dequant_u8(x, s, b, out_dtype=torch.int32)


def test_ref_is_unfused_f32():
    q, scale, bias = _inputs((50, 7), seed=9)
    got = ref.dequant_u8_ref(torch.from_numpy(q), torch.from_numpy(scale),
                             torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), (q.astype(np.float32) * scale) + bias)



def _emulate_kernel(q, scale, bias, E, blocks, stride):
    """The CUDA kernel's index map, in numpy: thread t < stride takes groups
    t, t + stride, ... of E codes, with the E channels it loaded once from
    (t * E) % C onwards; block 0's threads take the last n % E codes. Checks
    that each code is written once and with its own channel, and returns the
    f32 results (multiply, then add, each rounded)."""
    n, C = q.size, scale.size
    groups = n // E
    out = np.full(n, np.nan, np.float32)
    hits = np.zeros(n, np.int64)
    t = np.arange(stride)
    chans = ((t * E) % C)[:, None] + np.arange(E)[None, :]
    chans %= C  # the kernel steps c and wraps it at C, also more than once when C < E
    k = 0
    while True:
        g = t + k * stride
        live = g < groups
        if not live.any():
            break
        idx = (g[live, None] * E + np.arange(E)[None, :]).ravel()
        ch = chans[live].ravel()
        assert (ch == idx % C).all(), "a thread's channels changed between its groups"
        out[idx] = q[idx].astype(np.float32) * scale[ch] + bias[ch]
        hits[idx] += 1
        k += 1
    tail = np.arange(groups * E, n)
    assert tail.size < dq.THREADS
    out[tail] = q[tail].astype(np.float32) * scale[tail % C] + bias[tail % C]
    hits[tail] += 1
    assert (hits == 1).all(), "a code was written twice or not at all"
    return out


@pytest.mark.parametrize("C", [1, 3, 4, 7, 16, 128, 130, 4096, 4097])
@pytest.mark.parametrize("out", [torch.float32, torch.float16, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("aligned", [True, False])
def test_dequant_kernel_geometry_keeps_each_thread_on_its_channels(C, out, aligned):
    """``dequant_u8.geometry`` plans the launch the CUDA kernel runs: held to
    the plain version bit for bit through a numpy emulation of the kernel's
    index map, on a small card (4 SMs: threads take many groups) and an H100
    (132 SMs), at n < 16, n a multiple of no group, and several rows. A
    misaligned pointer takes groups of one code."""
    E = dq.group_codes(out) if aligned else 1
    for rows, sms in ((37, 4), (37, 132), (1, 132)):
        shape = (rows, C) if rows > 1 or C > 16 else (C,)
        q, scale, bias = _inputs(shape, seed=rows + C)
        n = q.size
        blocks, stride = dq.geometry(n, C, E, sms)
        assert 1 <= stride <= blocks * dq.THREADS
        period = C // np.gcd(C, E)
        assert stride % period == 0 or stride >= n // E
        assert blocks <= max(dq.MAX_BLOCKS_PER_SM * sms, -(-min(period, n // E) // dq.THREADS))
        got = _emulate_kernel(q.ravel(), scale, bias, E, blocks, stride)
        want = ref.dequant_u8_ref(torch.from_numpy(q), torch.from_numpy(scale),
                                  torch.from_numpy(bias), out)
        assert torch.equal(torch.from_numpy(got).to(out).view(shape), want)
