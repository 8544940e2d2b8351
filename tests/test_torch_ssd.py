"""The port's ``ssd_scan`` and its plain version against the JAX package.

Inputs come from numpy seeds and go to both packages. On the CPU the port's
``ops.ssd_scan`` runs its plain PyTorch version (``repro_torch.kernels.ref.
ssd_scan_ref``, the chunked dual form with einsums); it is held against the
JAX package's Pallas kernel in interpret mode (as ``tests/test_kernels.py``
runs it), its sequential oracle ``repro.kernels.ref.ssd_scan_ref`` and the
final state of the model's ``ssd_chunked``, at ``tests/test_kernels.py``'s
f32 tolerance (rtol 1e-3, atol 1e-4). bf16 inputs are held at 2e-2 of the
output's scale (one bf16 rounding of y, 2**-8 relative, plus the inputs'
own rounding through the sums). The CUDA kernel is held against the same
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.core.spec import RawArrayError
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models.mamba import ssd_chunked

RTOL, ATOL = 1e-3, 1e-4  # tests/test_kernels.py:79
BF16_TOL = 2e-2


def _inputs(seed, B, H, L, P, N, decay=0.3):
    """x (B,H,L,P), dtA (B,H,L) <= 0, Bm, Cm (B,L,N) as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, H, L, P)) * 0.5).astype(np.float32)
    dtA = -np.abs(rng.standard_normal((B, H, L)) * decay).astype(np.float32)
    Bm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    return x, dtA, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("B,H,L,P,N,chunk", [
    (1, 2, 128, 32, 16, 32),
    (2, 3, 256, 64, 32, 64),
    (1, 1, 64, 16, 8, 64),   # single chunk
])
def test_ssd_scan_matches_jax(B, H, L, P, N, chunk):
    """tests/test_kernels.py:67-79's sweep through both packages."""
    arrays = _inputs(B * 100 + L + P, B, H, L, P, N)
    want_kernel = jops.ssd_scan(*_j(*arrays), chunk=chunk, interpret=True)
    want_seq = jref.ssd_scan_ref(*_j(*arrays))
    got = tops.ssd_scan(*_t(*arrays), chunk=chunk)
    y, state = tref.ssd_scan_ref(*_t(*arrays), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (B, H, L, P)
    assert torch.equal(got, y)  # the CPU path is the plain version
    assert state.dtype == torch.float32 and state.shape == (B, H, P, N)
    _close(got, want_kernel)
    _close(got, want_seq)


def test_final_state_matches_jax_ssd_chunked():
    """The state after the last chunk equals the JAX model's ``final``
    (tests/test_kernels.py:82-96's inputs, in the model layout)."""
    B, H, L, P, N = 2, 2, 128, 16, 8
    x, dtA, Bm, Cm = _inputs(11, B, H, L, P, N, decay=0.2)
    u = np.moveaxis(x, 1, 2).copy()       # (B, L, H, P)
    a = np.moveaxis(dtA, 1, 2).copy()     # (B, L, H)
    jy, jfinal = jax_ssd_chunked(*_j(u, a, Bm, Cm), chunk=32)
    ty, tfinal = ssd_chunked(*_t(u, a, Bm, Cm), chunk=32)
    assert tuple(ty.shape) == (B, L, H, P) and tuple(tfinal.shape) == (B, H, P, N)
    _close(ty, jy)
    _close(tfinal, jfinal)
    y, state = tops.ssd_scan(*_t(x, dtA, Bm, Cm), chunk=32, return_state=True)
    assert torch.equal(state, tfinal)
    _close(y, np.moveaxis(np.asarray(jy), 2, 1))


def test_bf16_inputs_with_f32_decay():
    """The serving path's dtypes: x, Bm, Cm in bf16, dtA in f32. Both
    packages widen to f32 inside and round y once to bf16."""
    x, dtA, Bm, Cm = _inputs(5, 2, 4, 256, 64, 32)
    jx, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm))
    want = np.asarray(jops.ssd_scan(jx, jnp.asarray(dtA), jB, jC, chunk=128, interpret=True),
                      np.float32)
    tx, tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bm, Cm))
    got = tops.ssd_scan(tx, torch.from_numpy(dtA), tB, tC, chunk=128)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    _close(got.float(), want, rtol=0, atol=BF16_TOL * scale)


@pytest.mark.parametrize("L,chunk", [(100, 128), (64, 128), (96, 32)],
                         ids=["q100", "single_chunk", "three_chunks"])
def test_runtime_chunk_lengths(L, chunk):
    """Q = min(chunk, L): a 100-token prompt scans one chunk of 100."""
    arrays = _inputs(L, 2, 3, L, 32, 16)
    got, state = tops.ssd_scan(*_t(*arrays), chunk=chunk, return_state=True)
    _close(got, jref.ssd_scan_ref(*_j(*arrays)))
    _close(got, jops.ssd_scan(*_j(*arrays), chunk=chunk, interpret=True))
    # the state carried over the whole sequence, one step at a time
    x, dtA, Bm, Cm = (a.astype(np.float64) for a in arrays)
    h = np.zeros(state.shape)
    for t in range(L):
        h = h * np.exp(dtA[:, :, t])[..., None, None] + \
            x[:, :, t, :, None] * Bm[:, None, None, t, :]
    _close(state, h)


def test_slow_decay_carries_state_across_chunks():
    """dtA in [-0.01, 0]: the state of every earlier chunk still reaches y,
    so a wrong carry (state · exp(Acs_last)) cannot pass."""
    x, _, Bm, Cm = _inputs(9, 1, 2, 512, 16, 8)
    dtA = -np.random.default_rng(10).uniform(0, 0.01, (1, 2, 512)).astype(np.float32)
    got = tops.ssd_scan(*_t(x, dtA, Bm, Cm), chunk=128)
    want = np.array(jref.ssd_scan_ref(*_j(x, dtA, Bm, Cm)))
    _close(got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())))
    # without the carry the last chunk's output is far from it
    alone = tops.ssd_scan(*_t(x[:, :, 384:], dtA[:, :, 384:], Bm[:, 384:], Cm[:, 384:]), chunk=128)
    assert float((alone - torch.from_numpy(want[:, :, 384:])).abs().max()) > 0.1


def test_length_not_a_multiple_of_the_chunk_raises():
    arrays = _t(*_inputs(0, 1, 2, 192, 16, 8))
    with pytest.raises(RawArrayError, match="multiple of chunk"):
        tops.ssd_scan(*arrays, chunk=128)


def test_bad_inputs_raise():
    x, dtA, Bm, Cm = _t(*_inputs(1, 1, 2, 64, 16, 8))
    with pytest.raises(RawArrayError, match="takes x"):
        tops.ssd_scan(x[0], dtA, Bm, Cm)
    with pytest.raises(RawArrayError, match="does not fit"):
        tops.ssd_scan(x, dtA[:, :, :32], Bm, Cm)
    with pytest.raises(RawArrayError, match="share a dtype"):
        tops.ssd_scan(x, dtA, Bm.double(), Cm.double())
    with pytest.raises(RawArrayError, match="forward-only"):
        tops.ssd_scan(x.requires_grad_(), dtA, Bm, Cm)
    with torch.no_grad():
        assert tops.ssd_scan(x, dtA, Bm, Cm).shape == x.shape


def _tf32(t):
    """float32 -> TF32 (10 mantissa bits), round to nearest even, as the
    tensor-core kernel rounds its TF32 operands."""
    b = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32).view(torch.float32)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _bf16_hi_lo(t):
    """t as the sum of two bf16 terms: bf16(t) + bf16(t - bf16(t))."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _tensor_core_scan(x, dtA, Bm, Cm, chunk, scores_operand, state_operand):
    """The bf16 tensor-core scan's arithmetic in plain PyTorch: C·Bᵀ in f32,
    its product with L rounded by ``scores_operand`` for ``y_diag`` (the
    kernel: two bf16 terms); the state rounded by ``state_operand`` for
    ``C·stateᵀ`` (the kernel keeps a bf16 copy); the decayed x rounded to
    TF32 for the update. Sums in f64 (the kernel's are f32), the state kept
    in f32, y rounded once to bf16."""
    B, H, L, P = x.shape
    N, Q = Bm.shape[-1], chunk
    nc = L // Q
    xf = x.float().reshape(B, H, nc, Q, P)
    acs = torch.cumsum(dtA.float().reshape(B, H, nc, Q), dim=-1)
    Bf = Bm.float().reshape(B, nc, Q, N).double()
    Cf = Cm.float().reshape(B, nc, Q, N).double()
    G = torch.einsum("bcin,bcjn->bcij", Cf, Bf).float()
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    decay = torch.exp((acs[..., :, None] - acs[..., None, :]).masked_fill(~tri, -1e9))
    y_diag = scores_operand(G[:, None] * decay).double() @ xf.double()
    last = acs[..., -1]
    xd = _tf32(xf * torch.exp(last[..., None] - acs)[..., None]).double()
    state = torch.zeros(B, H, P, N, dtype=torch.float32)
    ys = []
    for c in range(nc):
        y_off = torch.einsum("bin,bhpn->bhip", Cf[:, c], state_operand(state).double())
        ys.append(y_diag[:, :, c] + y_off * torch.exp(acs[:, :, c]).double()[..., None])
        own = torch.einsum("bhjp,bjn->bhpn", xd[:, :, c], Bf[:, c])
        state = (state.double() * torch.exp(last[:, :, c]).double()[..., None, None] + own).float()
    return torch.stack(ys, dim=2).reshape(B, H, L, P).to(torch.bfloat16), state


def test_tf32_rounds_to_nearest_even():
    one = 1.0 + 2.0 ** -10  # the TF32 step above 1
    t = torch.tensor([1.0, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11, one + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11 + 2.0 ** -20), 3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1.0, one + 2.0 ** -10, -one, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32(t), want)


@pytest.mark.parametrize("scores_operand,state_operand", [
    (_bf16, _tf32),        # G ⊙ L in bf16, the state in TF32
    (_bf16_hi_lo, _bf16),  # the kernel: G ⊙ L in two bf16 terms, the state copy in bf16
], ids=["scores_bf16_state_tf32", "kernel"])
@pytest.mark.parametrize("B,H,L,P,N,decay", [
    (2, 4, 512, 64, 128, (0.5, 8.0)),   # the serving shape, batch and heads cut
    (1, 2, 4096, 64, 128, (0.0, 0.01)),  # slow decay: the state crosses 32 chunks
], ids=["serving_reduced", "slow_decay_32_chunks"])
def test_tensor_core_roundings_fit_the_tolerance(B, H, L, P, N, decay, scores_operand,
                                                 state_operand):
    """The roundings of the tensor-core scan stay inside the card's
    tolerances against the plain version: y within 2e-2 of its scale, the
    final state within 1e-3 of its scale."""
    rng = np.random.default_rng(L + H)
    x, Bm, Cm = (torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
                 .to(torch.bfloat16) for s in ((B, H, L, P), (B, L, N), (B, L, N)))
    dtA = torch.from_numpy(-rng.uniform(*decay, (B, H, L)).astype(np.float32))
    y, state = _tensor_core_scan(x, dtA, Bm, Cm, 128, scores_operand, state_operand)
    want, want_state = tref.ssd_scan_ref(x.float(), dtA, Bm.float(), Cm.float(), chunk=128)
    y_err = float((y.float() - want).abs().max())
    state_err = float((state - want_state).abs().max())
    assert 0 < y_err <= 2e-2 * float(want.abs().max())
    assert 0 < state_err
    torch.testing.assert_close(state, want_state, rtol=1e-3,
                               atol=1e-3 * max(1.0, float(want_state.abs().max())))


def test_kernel_roundings_add_little_to_the_rounding_of_y():
    """At the model's decay the kernel's roundings leave y as close to the
    exact scan as y's own bf16 rounding leaves it (RMS, within 10%): G ⊙ L
    in one bf16 term does not (it adds some 40%, which 48 layers carry into
    the first-step logits)."""
    rng = np.random.default_rng(7)
    B, H, L, P, N = 2, 8, 512, 64, 128
    x, Bm, Cm = (torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
                 .to(torch.bfloat16) for s in ((B, H, L, P), (B, L, N), (B, L, N)))
    dtA = torch.from_numpy(-rng.uniform(0.5, 8.0, (B, H, L)).astype(np.float32))
    exact, _ = tref.ssd_scan_ref(x.double(), dtA.double(), Bm.double(), Cm.double(), chunk=128)

    def rms(y):
        return float(((y.double() - exact) ** 2).mean().sqrt() / (exact ** 2).mean().sqrt())

    kernel, _ = _tensor_core_scan(x, dtA, Bm, Cm, 128, _bf16_hi_lo, _bf16)
    one_term, _ = _tensor_core_scan(x, dtA, Bm, Cm, 128, _bf16, _bf16)
    assert rms(kernel) <= 1.1 * rms(exact.to(torch.bfloat16))
    assert rms(one_term) > 1.3 * rms(exact.to(torch.bfloat16))


@pytest.mark.parametrize("B,H,P,sms,tile", [
    (8, 48, 64, 132, 64),   # the serving batch fills the card: no split
    (1, 48, 64, 132, 32),   # one long prompt: two tiles a head
    (1, 2, 32, 132, 16),    # a tiny call: as many as a tile of 16 allows
    (1, 1, 64, 132, 16),    # at most four tiles
])
def test_state_split(B, H, P, sms, tile):
    assert tssd.state_split(B, H, P, sms) == tile
