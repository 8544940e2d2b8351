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

The scan's gradients: ``ops.ssd_scan`` under autograd (on the CPU the plain
scan's autograd) and the plain backward ``ref.ssd_scan_bwd_ref`` (the
backward kernel's passes, its oracle on the card) are held to ``jax.grad``
of the JAX model's ``ssd_chunked`` in f32 within ``GRAD_TOL`` (1e-5) of
each gradient's largest entry: both compute in f32, in another order of
sums. ``SsdScan`` on CPU tensors (the plain forward and backward under the
op the card runs with its kernels) gives the plain backward's gradients. A
CPU emulation of the backward kernel's plan (``ssd_scan.bwd_geometry``)
walks its blocks, slabs and per-head partial sums.
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
GRAD_TOL = 1e-5  # of each gradient's largest |entry|: f32 sums in another order


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
    x.requires_grad_()
    with pytest.raises(RawArrayError, match="records no gradient"):
        tssd.ssd_scan_fwd(x, dtA, Bm, Cm, chunk=64)  # the bare kernel call records none
    with pytest.raises(RawArrayError, match="no backward"):
        tops.ssd_scan(x, dtA, Bm, Cm, return_state=True)  # nor is the final state
    assert tops.ssd_scan(x, dtA, Bm, Cm).grad_fn is not None
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


# ------------------------------------------------------------------ gradients
def _jax_grads(x, dtA, Bm, Cm, dy, chunk):
    """jax.grad of the JAX model's ``ssd_chunked`` (model layout, chunk
    ``min(chunk, L)``) for the cotangent dy, moved to the kernel's layout."""
    import jax

    def f(u, a, b, c):
        y, _ = jax_ssd_chunked(u, a, b, c, chunk)
        return jnp.sum(y * jnp.asarray(np.moveaxis(dy, 1, 2)))

    g = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
        jnp.asarray(np.moveaxis(x, 1, 2)), jnp.asarray(np.moveaxis(dtA, 1, 2)),
        jnp.asarray(Bm), jnp.asarray(Cm))
    return (np.moveaxis(np.asarray(g[0]), 2, 1), np.moveaxis(np.asarray(g[1]), 2, 1),
            np.asarray(g[2]), np.asarray(g[3]))


def _grad_close(got, want, name):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=GRAD_TOL * float(np.abs(want).max()), err_msg=name)


GRAD_SHAPES = {  # (B, H, L, P, N, chunk, dtA range)
    "one_chunk": (2, 3, 32, 8, 16, 32, 0.3),
    "several_chunks": (2, 3, 96, 8, 16, 32, 0.3),
    "runtime_chunk_below": (1, 2, 100, 8, 16, 128, 0.3),  # Q = min(128, 100)
    "n64": (1, 2, 128, 16, 64, 64, 0.3),
    "slow_decay": (1, 2, 256, 8, 16, 64, 0.01),  # the gradient crosses every chunk
}


@pytest.mark.parametrize("shape", list(GRAD_SHAPES), ids=list(GRAD_SHAPES))
def test_scan_gradients_match_jax(shape):
    """The port's scan under autograd, the plain backward and autograd of the
    plain scan against ``jax.grad`` of ``ssd_chunked``, in f32."""
    B, H, L, P, N, chunk, decay = GRAD_SHAPES[shape]
    x, dtA, Bm, Cm = _inputs(L + N, B, H, L, P, N, decay=decay)
    dy = np.random.default_rng(L).standard_normal((B, H, L, P)).astype(np.float32)
    Q = min(chunk, L)
    want = _jax_grads(x, dtA, Bm, Cm, dy, chunk)
    leaves = [t.requires_grad_() for t in _t(x, dtA, Bm, Cm)]
    got = torch.autograd.grad(tops.ssd_scan(*leaves, chunk=chunk), leaves, torch.from_numpy(dy))
    plain = tref.ssd_scan_bwd_ref(*_t(x, dtA, Bm, Cm, dy), chunk=Q)
    auto = torch.autograd.grad(tref.ssd_scan_ref(*leaves, chunk=Q)[0], leaves,
                               torch.from_numpy(dy))
    for name, g, p, a, w in zip(("dx", "ddtA", "dB", "dC"), got, plain, auto, want):
        assert p.dtype == torch.float32 and p.shape == g.shape, name
        _grad_close(g.numpy(), w, name)
        _grad_close(p.numpy(), w, name)
        _grad_close(p.numpy(), a.numpy(), name)


def test_masked_triangle_takes_no_gradient():
    """The mask comes before the exp: a fast decay (exp(Acs_j - Acs_i) past
    f32's range above the diagonal) gives finite gradients, equal to the
    ones at a decay where nothing overflows wherever the decay leaves an
    entry unchanged (the first step of each chunk, whose dx is its own)."""
    x, dtA, Bm, Cm = _inputs(3, 1, 2, 64, 8, 16)
    dtA = np.full_like(dtA, -200.0)  # Acs reaches -12,800 in a chunk of 64
    dy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    got = tref.ssd_scan_bwd_ref(*_t(x, dtA, Bm, Cm, dy), chunk=64)
    assert all(torch.isfinite(g).all() for g in got)
    want = _jax_grads(x, dtA, Bm, Cm, dy, 64)
    for name, g, w in zip(("dx", "ddtA", "dB", "dC"), got, want):
        assert np.isfinite(w).all(), name
        _grad_close(g.numpy(), w, name)


def test_ssd_scan_op_on_cpu_gives_the_plain_backward():
    """``SsdScan`` (the op the card runs with its kernels) on CPU tensors: the
    plain forward, then ``ssd_scan_bwd``'s plain version, with the inputs'
    dtypes (bf16 x, B and C; f32 dtA)."""
    x, dtA, Bm, Cm = _inputs(8, 2, 3, 64, 32, 16)
    dy = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    tx, tB, tC, tdy = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bm, Cm, dy))
    leaves = [t.requires_grad_() for t in (tx, torch.from_numpy(dtA), tB, tC)]
    y = tssd.SsdScan.apply(*leaves, 32)
    assert torch.equal(y, tref.ssd_scan_ref(*(t.detach() for t in leaves), chunk=32)[0])
    got = torch.autograd.grad(y, leaves, tdy)
    want = tssd.ssd_scan_bwd(*(t.detach() for t in leaves), tdy, chunk=32)
    for g, w, t in zip(got, want, leaves):
        assert g.dtype == t.dtype and torch.equal(g, w)


def _emulate_backward(plan, x, dtA, Bm, Cm, dy, Q):
    """The backward kernel's walk in float64, block by block as its plan
    lays the grids out: the scan blocks (h, b) walk the chunks first to last
    and last to first; the chunk blocks (c, h, b) each finish their chunk's
    dx, d(dtA) and per-head dB/dC partials in 32-row slabs (a row pass for
    dC and the row sums, a column pass for dx, dB and the column sums); the
    reduction sums the partials over h in order. Returns the gradients and
    how many times each (b, h, chunk) was visited by each kernel."""
    B, H, L, P = x.shape
    N = Bm.shape[-1]
    nc = plan.n_chunks
    x, dy, Bm, Cm = (t.double() for t in (x, dy, Bm, Cm))
    acs = torch.cumsum(dtA.double().reshape(B, H, nc, Q), -1)
    states = torch.zeros(plan.states, dtype=torch.float64)
    dstates = torch.zeros(plan.states, dtype=torch.float64)
    gs = torch.zeros(plan.gs, dtype=torch.float64)
    visits = {"scan": torch.zeros(B, H, nc, dtype=torch.int64),
              "chunk": torch.zeros(B, H, nc, dtype=torch.int64)}
    H_, B_ = plan.scan_grid
    for b in range(B_):
        for h in range(H_):
            s = torch.zeros(P, N, dtype=torch.float64)
            for c in range(nc):
                rows = slice(c * Q, (c + 1) * Q)
                lam = acs[b, h, c, -1]
                states[b, h, c] = s
                s = s * torch.exp(lam) + (x[b, h, rows] * torch.exp(lam - acs[b, h, c])[:, None]).T \
                    @ Bm[b, rows]
            g = torch.zeros(P, N, dtype=torch.float64)
            for c in reversed(range(nc)):
                rows = slice(c * Q, (c + 1) * Q)
                lam = acs[b, h, c, -1]
                dstates[b, h, c] = g
                gs[b, h, c] = torch.exp(lam) * (g * states[b, h, c]).sum()
                g = g * torch.exp(lam) + (dy[b, h, rows] * torch.exp(acs[b, h, c])[:, None]).T \
                    @ Cm[b, rows]
                visits["scan"][b, h, c] += 1
    dx = torch.zeros(B, H, L, P, dtype=torch.float64)
    dta = torch.zeros(B, H, L, dtype=torch.float64)
    parts = {k: torch.zeros(plan.parts, dtype=torch.float64) for k in ("dB", "dC")}
    nc_, H_, B_ = plan.chunk_grid
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    for b in range(B_):
        for h in range(H_):
            for c in range(nc_):
                visits["chunk"][b, h, c] += 1
                rows = slice(c * Q, (c + 1) * Q)
                a, lam = acs[b, h, c], acs[b, h, c, -1]
                xc, dyc, Bc, Cc = x[b, h, rows], dy[b, h, rows], Bm[b, rows], Cm[b, rows]
                s, g = states[b, h, c], dstates[b, h, c]
                Lm = torch.where(tri, torch.exp(a[:, None] - a[None, :]), torch.zeros(()))
                e, ep = torch.exp(a), torch.exp(lam - a)
                drow, dcol = torch.zeros(Q, dtype=torch.float64), torch.zeros(Q, dtype=torch.float64)
                for i0 in range(0, Q, plan.slab):  # row pass
                    i1 = min(Q, i0 + plan.slab)
                    D = (dyc[i0:i1] @ xc[:i1].T) * Lm[i0:i1, :i1]
                    M = D * (Cc[i0:i1] @ Bc[:i1].T)
                    drow[i0:i1] = M.sum(1) + e[i0:i1] * (dyc[i0:i1] * (Cc[i0:i1] @ s.T)).sum(1)
                    dcol[:i1] += M.sum(0)
                    parts["dC"][b, h, c * Q + i0:c * Q + i1] = D @ Bc[:i1] \
                        + e[i0:i1, None] * (dyc[i0:i1] @ s)
                w = torch.zeros(Q, dtype=torch.float64)
                for j0 in range(0, Q, plan.slab):  # column pass
                    j1 = min(Q, j0 + plan.slab)
                    A = (Cc[j0:] @ Bc[j0:j1].T) * Lm[j0:, j0:j1]
                    D = (dyc[j0:] @ xc[j0:j1].T) * Lm[j0:, j0:j1]
                    off = ep[j0:j1, None] * (Bc[j0:j1] @ g.T)
                    dx[b, h, c * Q + j0:c * Q + j1] = A.T @ dyc[j0:] + off
                    w[j0:j1] = (xc[j0:j1] * off).sum(1)
                    parts["dB"][b, h, c * Q + j0:c * Q + j1] = D.T @ Cc[j0:] \
                        + ep[j0:j1, None] * (xc[j0:j1] @ g)
                dacs = drow - dcol - w
                dacs[-1] += w.sum() + gs[b, h, c]
                dta[b, h, rows] = torch.flip(torch.cumsum(torch.flip(dacs, [0]), 0), [0])
    out = {}
    for k, p in parts.items():  # the reduction: over h, in order
        total = torch.zeros(B, L, N, dtype=torch.float64)
        for h in range(H):
            total = total + p[:, h]
        out[k] = total
    return (dx, dta, out["dB"], out["dC"]), visits


@pytest.mark.parametrize("B,H,L,P,N,chunk", [
    (2, 3, 96, 8, 16, 32),   # three chunks of one slab
    (1, 2, 200, 8, 16, 100),  # Q 100: slabs of 32, 32, 32 and 4
    (1, 1, 64, 4, 8, 64),    # one chunk of two slabs
])
def test_backward_plan_covers_every_chunk_once(B, H, L, P, N, chunk):
    """The plan's grids visit every (b, h, chunk) once in each kernel, its
    slabs cover each chunk's rows and columns, its shared memory fits a
    block on the H100 at the largest chunk, and the walk they lay out, with
    the per-head partials summed over h in order, gives the plain backward's
    gradients (float64 against f32: 1e-5 of each one's largest entry)."""
    plan = tssd.bwd_geometry(B, H, L, P, N, chunk)
    assert plan.n_chunks * chunk == L and plan.slab == 32 and plan.threads == 256
    assert plan.reduce_grid[0] * plan.threads >= B * L * N and plan.reduce_grid[1] == 2
    big = tssd.bwd_geometry(4, 48, 2048, 64, 128, 128)
    assert (big.chunk_smem, big.scan_smem) == (193040, 101392)  # csrc/ssd_scan_bwd.cu's note
    assert big.chunk_smem <= 232448  # an H100 block's most shared memory
    x, dtA, Bm, Cm = _inputs(L + chunk, B, H, L, P, N)
    dy = np.random.default_rng(1).standard_normal((B, H, L, P)).astype(np.float32)
    got, visits = _emulate_backward(plan, *_t(x, dtA, Bm, Cm, dy), chunk)
    assert (visits["scan"] == 1).all() and (visits["chunk"] == 1).all()
    want = tref.ssd_scan_bwd_ref(*_t(x, dtA, Bm, Cm, dy), chunk=chunk)
    for name, g, w in zip(("dx", "ddtA", "dB", "dC"), got, want):
        _grad_close(g.numpy(), w.double().numpy(), name)


def test_backward_sums_over_heads_in_a_fixed_order():
    """The per-head partials are summed over h in one order: the result is
    the left fold over h in f32, bit for bit, the same on every call, and
    another order of the same partials may differ in its last bits (so the
    order is a choice the kernel has to fix)."""
    rng = np.random.default_rng(2)
    parts = torch.from_numpy((rng.standard_normal((2, 48, 64, 128)) * 3).astype(np.float32))
    fold = torch.zeros(2, 64, 128)
    for h in range(48):
        fold = fold + parts[:, h]
    again = torch.zeros(2, 64, 128)
    for h in range(48):
        again = again + parts[:, h]
    assert torch.equal(fold, again)
    backwards = torch.zeros(2, 64, 128)
    for h in reversed(range(48)):
        backwards = backwards + parts[:, h]
    assert not torch.equal(fold, backwards)
    torch.testing.assert_close(fold, backwards, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_1_2b"])
def test_trained_ssm_configs_fit_the_backward_kernel(arch):
    """The card must train what the CPU trains: each ssm and hybrid config's
    head dim, state width and chunk (full and reduced) are ones the backward
    kernel is instantiated for, and its plan fits an H100 block."""
    from repro_torch.configs import get_config

    for cfg in (get_config(arch), get_config(arch).reduced()):
        s = cfg.ssm
        assert s.headdim in tssd.BWD_HEAD_DIMS and s.d_state in tssd.BWD_STATE_DIMS
        assert s.chunk <= tssd.MAX_CHUNK
        plan = tssd.bwd_geometry(4, cfg.n_ssm_heads, 2048, s.headdim, s.d_state, s.chunk)
        assert max(plan.chunk_smem, plan.scan_smem) <= 232448


@pytest.fixture(scope="module")
def emulated_backward(tmp_path_factory):
    """``csrc/ssd_scan_bwd.cu`` itself, compiled for the CPU against the
    emulator of the CUDA subset it uses (``tests/cuda_emu``: a block's
    threads as ``std::thread``s, ``__syncthreads`` a barrier, warp shuffles
    an exchange) and loaded with ``ctypes``: its C entry point, called with
    CPU pointers and the Python plan, as the wrapper calls it on the card."""
    import ctypes
    import pathlib
    import shutil
    import subprocess
    import sys

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU emulator")
    here = pathlib.Path(__file__).resolve().parent / "cuda_emu"
    sys.path.insert(0, str(here))
    try:
        from emu import translate
    finally:
        sys.path.remove(str(here))
    src = pathlib.Path(tssd.__file__).with_name("csrc") / "ssd_scan_bwd.cu"
    out = tmp_path_factory.mktemp("emu")
    (out / "k.cpp").write_text(translate(src.read_text()))
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-w",
                    f"-I{here}", "-o", str(out / "k.so"), str(out / "k.cpp")], check=True)
    fn = ctypes.CDLL(str(out / "k.so")).ssd_scan_bwd_launch
    fn.argtypes, fn.restype = tssd._BWD_ARGTYPES, ctypes.c_int
    return fn


@pytest.mark.parametrize("B,H,L,P,N,chunk,dtype,decay", [
    (1, 2, 96, 32, 16, 32, torch.float32, 0.3),        # three chunks of one slab
    (2, 1, 80, 32, 32, 40, torch.float32, 0.3),        # Q 40: a slab of 32 and one of 8
    (1, 1, 100, 32, 16, 100, torch.float32, 0.3),      # Q 100, one chunk
    (1, 2, 256, 32, 16, 64, torch.float32, 0.01),      # slow decay over four chunks
    (1, 1, 256, 64, 128, 128, torch.float32, 0.3),     # Mamba2's P, N and chunk
    (1, 2, 128, 64, 64, 64, torch.bfloat16, 8.0),      # bf16 at Zamba2's N
], ids=["three_chunks", "q40", "q100", "slow_decay", "mamba2_widths", "bf16_n64"])
def test_backward_kernel_source_on_a_cpu_emulator(emulated_backward, B, H, L, P, N, chunk,
                                                  dtype, decay):
    """The backward kernel's own source, run on the emulator, against the
    plain backward: f32 within 1e-5 of each gradient's largest entry (sums in
    another order), bf16 within one rounding of the outputs (2e-2, as on the
    card); scratch filled with NaN first, so a read of an entry the kernel
    never wrote shows."""
    g = torch.Generator().manual_seed(L + N)
    x, dy = ((torch.randn(B, H, L, P, generator=g) * 0.5).to(dtype) for _ in range(2))
    Bm, Cm = ((torch.randn(B, L, N, generator=g) * 0.5).to(dtype) for _ in range(2))
    dtA = -decay * torch.rand(B, H, L, generator=g)
    plan = tssd.bwd_geometry(B, H, L, P, N, chunk)
    dx, dB, dC, da = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm), \
        torch.empty(B, H, L)
    scratch = [torch.full(shape, float("nan"))
               for shape in (plan.states, plan.states, plan.gs, plan.parts, plan.parts)]
    err = emulated_backward(
        x.data_ptr(), dy.data_ptr(), dtA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        dx.data_ptr(), da.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        *(t.data_ptr() for t in scratch), B, H, L, P, N, chunk, plan.slab, plan.scan_smem,
        plan.chunk_smem, tssd.DTYPES[dtype], None)
    assert err == 0
    want = tref.ssd_scan_bwd_ref(x, dtA, Bm, Cm, dy, chunk=chunk)
    tol = GRAD_TOL if dtype == torch.float32 else BF16_TOL
    for name, got, w in zip(("dx", "ddtA", "dB", "dC"), (dx, da, dB, dC), want):
        assert torch.isfinite(got.float()).all(), name
        scale = float(w.float().abs().max())
        torch.testing.assert_close(got.float(), w.float(), rtol=0, atol=tol * scale, msg=name)


def test_emulated_backward_rejects_a_plan_it_does_not_share(emulated_backward):
    """The launch checks the Python plan's shared-memory sizes and slab
    against its own and refuses a mismatch (cudaErrorInvalidValue, 1)."""
    plan = tssd.bwd_geometry(1, 1, 64, 32, 16, 32)
    t = torch.zeros(4096)
    ptrs = [t.data_ptr()] * 14
    args = (1, 1, 64, 32, 16, 32)
    for slab, scan, chunk in ((16, plan.scan_smem, plan.chunk_smem),
                              (plan.slab, plan.scan_smem + 4, plan.chunk_smem),
                              (plan.slab, plan.scan_smem, plan.chunk_smem - 4)):
        assert emulated_backward(*ptrs, *args, slab, scan, chunk, 0, None) == 1
