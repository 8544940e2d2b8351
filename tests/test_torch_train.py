"""The port's training slice against the JAX package: AdamW, the loss and
its gradients, one step, the train loop, resume and preemption, and
checkpoints that cross between the packages, all on the CPU.

Inputs come from numpy seeds; parameters are carried across with
``models/convert.py``. On the CPU the port's attention runs its plain
versions, forward and backward (``kernels/ref.py``), under the
``autograd.Function`` the card runs with its kernels. Tolerances, each with
its reason:

* AdamW (``OPT_TOL``, rtol 1e-6, atol 1e-7): the same f32 arithmetic, with
  the elementwise ops in the same order; XLA and PyTorch may contract a
  multiply-add differently, a few ulps of the f32 moments at most. With int8
  moments such an ulp can move a value across a rounding edge of its code:
  then that code is one apart, and its parameter moves by up to a code's
  share of the step (``FLIP_ATOL``, 2e-2 of lr); at most 1e-4 of the entries
  may do so;
* the loss (``LOSS_TOL``, rtol 1e-5) and every gradient (``GRAD_TOL``, 1e-3
  of each leaf's largest |gradient|): f32 sums taken in another order through
  the attention and the chunked loss, and RoPE's sin/cos rounding differently
  in the two packages (the worst leaf seen is 1.6e-4 of its scale: the tied
  embedding, whose gradient sums every token's);
* parameters after one step: AdamW's first steps move an entry by
  lr·g/(|g| + eps), close to lr·sign(g), so an entry whose gradient is
  within rounding of zero may step the other way, and one whose |g| is
  within a few hundred eps moves by far more than its gradient's rounding.
  So the step's gradient is held to ``GRAD_TOL`` and its update to
  ``OPT_TOL`` against the reference's update of that same gradient; the two
  whole steps are only held to 2·lr apart (a flipped sign);
* per-step losses of a run (``_losses_close``): the k-th step after a state
  both packages share within ``LOSS_TOL``·10^k, at most ``DRIFT_CAP`` (3e-2).
  Those few entries, and the rounding differences, grow by a factor of 5-10
  a step in this small model on most runs; so does the reference's own run
  when its weights are perturbed by 1e-7. A flipped entry is a jump, not a
  growth, though: over the same six steps of the tiny model, the gap grew by
  up to 420× in one step, by the BLAS thread count. So the loop's own test
  starts each comparison from a state the two packages share (the
  reference's checkpoint of a step) and holds the next two losses;
* straight against resumed runs of one package: the reference's own
  ``tests/test_system.py`` tolerance (rtol 1e-5, atol 1e-6).
"""

import os
import shutil
import signal
import subprocess
import sys
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.store import _leaf_name
from repro.configs import get_config as jax_config
from repro.data import DataLoader as JaxLoader
from repro.data import RaDataset as JaxDataset
from repro.distributed import optimizer as jopt
from repro.models import build_model as jax_build
from repro.models import common as jax_common
from repro.models.common import cross_entropy_loss as jax_ce
from repro.train import TrainLoopConfig as JaxLoopConfig
from repro.train import train as jax_train
from repro_torch.checkpoint import CheckpointManager, latest_step, load_checkpoint
from repro_torch.checkpoint import store as tstore
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import get_config
from repro_torch.data import DataLoader, RaDataset, make_token_dataset
from repro_torch.distributed import optimizer as topt
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import parse_args, run as train_run
from repro_torch.models import build_model
from repro_torch.models.common import cross_entropy_loss
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.models.transformer import token_ids
from repro_torch.train import TrainLoopConfig, train

OPT_TOL = dict(rtol=1e-6, atol=1e-7)
FLIP_ATOL = 2e-2  # of lr
FLIP_SHARE = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
DRIFT_CAP = 3e-2
RESUME_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_system.py:49-70

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=256, max_seq=64)


def _losses_close(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        tol = min(LOSS_TOL * 10 ** k, DRIFT_CAP)
        assert abs(g - w) <= tol * abs(w), f"step {k}: {g} vs {w} (rtol {tol})"


def _tiny(get):
    return get("paper_lm").with_(**TINY)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train") / "ds")
    make_token_dataset(root, n_docs=128, seq_len=32, vocab=TINY["vocab"], shard_rows=64)
    return root


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ AdamW
def _tree(rng, stacked: bool):
    tree = {
        "w": rng.standard_normal((3, 300)).astype(np.float32),    # matrix: decayed
        "b": rng.standard_normal((5,)).astype(np.float32),        # vector: not decayed
        "deep": {"k": rng.standard_normal((2, 3, 200)).astype(np.float32)},
    }
    if stacked:  # a layer stack the update walks a layer at a time
        tree["stack"] = rng.standard_normal((2, 1024, 1030)).astype(np.float32)
    return tree


def _to_torch(tree):
    return topt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("stacked", [False, True])
def test_apply_updates_matches_jax(moments, stacked):
    """Three steps: the warmup and cosine schedule, clipping by the global
    norm (clip 0.5 against norms near 50), decay on matrices only, int8
    blockwise moments; parameters, moments and step against the reference's."""
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=0.5, weight_decay=0.1,
              moment_dtype=moments)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    params = _tree(rng, stacked)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _to_torch(params)
    js, ts = jopt.init_state(jp, jcfg), topt.init_state(tp, tcfg)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        jp, js, jinfo = jopt.apply_updates(jp, jax.tree_util.tree_map(jnp.asarray, grads),
                                           js, jcfg)
        tp, ts, tinfo = topt.apply_updates(tp, _to_torch(grads), ts, tcfg)
        np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]), rtol=1e-7)
        np.testing.assert_allclose(float(tinfo["grad_norm"]), float(jinfo["grad_norm"]),
                                   rtol=1e-6)
    flips = moments == "int8"
    for a, b in zip(jax.tree_util.tree_leaves(jp), topt.leaves(tp)):
        _close_or_flipped(b.numpy(), np.asarray(a), flips, FLIP_ATOL * kw["lr"])
    jleaves, tleaves = jax.tree_util.tree_leaves(js), topt.leaves(ts)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert str(b.dtype).rsplit(".", 1)[-1] == str(a.dtype)
        got, want = b.numpy().astype(np.float64), np.asarray(a).astype(np.float64)
        if b.dtype == torch.int8:
            _close_or_flipped(got, want, True, 1.0)  # a code one apart
        else:
            _close_or_flipped(got, want, flips, np.abs(want).max() / 127 + 1e-12)
    assert int(ts["step"]) == 3


def test_int8_moments_move_a_vanished_gradient_by_m_over_eps():
    """The reference's int8 moments (ROADMAP.md §3, fault 10), mirrored: a
    block's absmax quantization keeps a small first moment (|g| above
    1/254 of the block's largest) and zeroes its second (|g| below 1/16 of
    it), so where the next gradient is exactly zero (an embedding row or an
    expert that the next batch does not reach) the second step divides the
    surviving first moment by eps alone and moves the entry by ~lr·m/eps;
    with f32 moments it moves by < lr. Both packages alike, at OPT_TOL."""
    g1 = np.full((1, 128), 0.05, np.float32)
    g1[0, 0] = 1.0
    kw = dict(lr=1e-6, warmup_steps=0, total_steps=10, grad_clip=0.0, weight_decay=0.0)
    moved = {}
    for moments in ("float32", "int8"):
        jcfg = jopt.AdamWConfig(**kw, moment_dtype=moments)
        tcfg = topt.AdamWConfig(**kw, moment_dtype=moments)
        jp, tp = {"w": jnp.zeros((1, 128))}, {"w": torch.zeros(1, 128)}
        js, ts = jopt.init_state(jp, jcfg), topt.init_state(tp, tcfg)
        for g in (g1, np.zeros_like(g1)):
            jp, js, _ = jopt.apply_updates(jp, {"w": jnp.asarray(g)}, js, jcfg)
            before = tp["w"].clone()
            tp, ts, _ = topt.apply_updates(tp, {"w": torch.from_numpy(g.copy())}, ts, tcfg)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), **OPT_TOL)
        moved[moments] = np.abs((tp["w"] - before).numpy()[0, 1:]).max() / kw["lr"]
    assert moved["float32"] < 1.0
    assert moved["int8"] > 1e4


def _close_or_flipped(got, want, flips: bool, flip_atol: float):
    """Within ``OPT_TOL``; or, where int8 codes may flip, all within
    ``flip_atol`` and at most ``FLIP_SHARE`` of the entries past ``OPT_TOL``."""
    if not flips:
        np.testing.assert_allclose(got, want, **OPT_TOL)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=flip_atol)
    off = ~np.isclose(got, want, **OPT_TOL)
    assert off.mean() <= FLIP_SHARE, f"{off.sum()} of {off.size} entries past OPT_TOL"


def test_lr_schedule_matches_jax():
    kw = dict(lr=1.0, warmup_steps=100, total_steps=1000, min_lr_frac=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    for s in (0, 1, 50, 99, 100, 101, 500, 999, 1000, 2000):
        want = float(jopt._lr_at(jnp.asarray(s), jcfg))
        got = float(topt._lr_at(torch.tensor(s), tcfg))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9), s


@pytest.mark.parametrize("n", [1, 127, 128, 300])
def test_quantize_blockwise_matches_jax(n):
    """Codes and scales equal the reference's; the round trip within one
    code of each block's absmax."""
    x = (np.random.default_rng(n).standard_normal((3, n)) * 5).astype(np.float32)
    jq = jopt.quantize_blockwise(jnp.asarray(x))
    tq = topt.quantize_blockwise(torch.from_numpy(x))
    assert torch.equal(tq["q"], torch.from_numpy(np.asarray(jq["q"])))
    np.testing.assert_array_equal(tq["scale"].numpy(), np.asarray(jq["scale"]))
    back = topt.dequantize_blockwise(tq, n).numpy()
    assert back.shape == x.shape
    assert np.abs(back - x).max() <= np.abs(x).max() / 127 * 1.001


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_optimizer_state_has_the_jax_leaf_names(moments):
    """The state tree's checkpoint leaves (``opt__m__...``, quantized
    ``...__q``/``...__scale``) have the reference's names, shapes and dtypes."""
    jmodel = jax_build(_tiny(jax_config))
    js = jax.eval_shape(lambda: jopt.init_state(jmodel.init(jax.random.PRNGKey(0)),
                                                jopt.AdamWConfig(moment_dtype=moments)))
    want = {_leaf_name(path, "opt"): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(js)[0]}
    port = build_model(_tiny(get_config), device="cpu")
    ts = topt.init_state(port.param_tree(), topt.AdamWConfig(moment_dtype=moments))
    got = {name: (tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1])
           for name, t in flatten(ts, "opt").items()}
    assert got == want


# ------------------------------------------------------------ loss and grads
def test_cross_entropy_matches_jax():
    """Value, accuracy and gradient, including the reference's own gradient
    term of the max (one-hot at the argmax)."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5))
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    (jl, ja), jg = jax.value_and_grad(
        lambda x: jax_ce(x, jnp.asarray(labels), jnp.asarray(mask)), has_aux=True)(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    tl, ta = cross_entropy_loss(t, torch.from_numpy(labels), torch.from_numpy(mask))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(ta) == float(ja)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


def _temper(params, cfg):
    """The JAX params with the attention projections scaled to their
    contraction width (``tests/test_torch_moe.py:_temper``; ROADMAP.md §3
    fault 4). At the reference's init scales some draws (some of fault 5's
    per-process hash salts) saturate the softmax, and the two packages' f32
    gradients then part by up to 1.6e-3 of a leaf's scale (``wq`` of
    ``paper_lm``), past ``GRAD_TOL``; tempered, by at most 2e-6 of it."""
    H, KV, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    factors = {"wq": H / d, "wk": KV / d, "wv": KV / d, "wo": 1 / H}
    layers = params["dense_layers"]
    attn = {k: v * factors[k] ** 0.5 if k in factors else v for k, v in layers["attn"].items()}
    return {**params, "dense_layers": {**layers, "attn": attn}}


def _path_hash(path):
    """A string hash that is the same in every process (crc32)."""
    return zlib.crc32(path.encode())


def _pair(arch, changes=None, seed=0, temper=False):
    """The reduced config's JAX model and params (the attention tempered if
    ``temper``), and the port's model holding the same params with its
    gradients on. The reference's init folds ``hash(path)`` into its key,
    which Python salts per process (ROADMAP.md §3 fault 5); here it folds
    ``_path_hash``, so every process draws the same params."""
    changes = changes or {}
    jmodel = jax_build(jax_config(arch).reduced().with_(**changes))
    with mock.patch.object(jax_common, "hash", _path_hash, create=True):
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    if temper:
        params = _temper(params, jmodel.cfg)
    port = build_model(get_config(arch).reduced().with_(**changes), device="cpu")
    load_params(port, params_from_jax(jax.device_get(params)))
    port.requires_grad_(True)
    return jmodel, params, port


def _tokens(cfg, B=2, S=48, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.uint32)


@pytest.mark.parametrize("arch,changes", [
    ("paper_lm", {}),
    ("internlm2_1_8b", {}),
    ("internlm2_1_8b", {"remat": True}),   # each layer under torch.utils.checkpoint
    ("qwen2_5_14b", {}),                   # qkv bias, padded heads, untied head
    ("gemma3_12b", {}),                    # window / global layers, sandwich norms, qk-norm
    ("olmo_1b", {}),                       # non-parametric LayerNorm
])
def test_train_loss_and_grads_match_jax(arch, changes):
    jmodel, params, port = _pair(arch, changes)
    cfg = port.cfg
    S = 80 if arch == "gemma3_12b" else 48  # past the reduced window (64)
    toks = _tokens(cfg, S=S)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_loss(p, {"tokens": jnp.asarray(toks.astype(np.int32))}),
        has_aux=True))(params)
    loss, met = port.train_loss({"tokens": torch.from_numpy(toks)})
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_TOL)
    for key in ("ce", "aux", "acc", "loss"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=LOSS_TOL,
                                   atol=1e-7)
    want = {name: np.asarray(g) for name, g in flatten(jax.device_get(jg), "param").items()}
    got = {name: p.grad for name, p in flatten(port.param_tree(), "param").items()}
    assert set(got) == set(want)
    for name, g in want.items():
        assert got[name] is not None, name
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(_np(got[name]), g, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg=name)


def test_token_ids_read_uint32_by_their_bits():
    toks = np.array([[0, 5, 92543, 2**31 - 1]], np.uint32)
    ids = token_ids(torch.from_numpy(toks), torch.device("cpu"))
    assert ids.dtype == torch.int64 and ids.tolist() == [[0, 5, 92543, 2**31 - 1]]
    assert token_ids(toks, torch.device("cpu")).tolist() == ids.tolist()


def test_one_adamw_step_matches_jax(monkeypatch):
    """From the same parameters and batch, one step of each package, held in
    two parts from states the packages share: the gradient the port's step
    hands its AdamW against ``jax.grad``'s (``GRAD_TOL``, as
    ``test_train_loss_and_grads_match_jax``), and the port's update against
    the reference's ``apply_updates`` of that same gradient (``OPT_TOL``).

    A first AdamW step moves an entry by lr·g/(|g| + eps). Where |g| is
    within a few hundred eps (a leaf whose gradient is tiny; the reference's
    init draws other weights in every process, ROADMAP.md §3 fault 5), a
    gradient's rounding moves that update by far more than the rounding, so
    the two packages' whole steps are held only to 2·lr apart (a flipped
    sign) and the update to the gradient it was given. The attention is
    tempered (``_temper``): at the reference's init scales some of its
    per-process draws part the two gradients past ``GRAD_TOL``."""
    jmodel, params, port = _pair("paper_lm", temper=True)
    toks = _tokens(port.cfg)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    batch = {"tokens": jnp.asarray(toks.astype(np.int32))}
    grads = jax.jit(jax.grad(lambda p: jmodel.train_loss(p, batch)[0]))(params)
    jp, _, _ = jopt.apply_updates(params, grads, jopt.init_state(params, jcfg), jcfg)

    from repro_torch.train import loop

    seen = {}
    apply = loop.optim.apply_updates

    def spy(p, g, state, cfg):
        seen["grads"] = topt.tree_map(lambda x: x.detach().clone(), g)
        return apply(p, g, state, cfg)

    monkeypatch.setattr(loop.optim, "apply_updates", spy)
    tparams = port.param_tree()
    state = topt.init_state(tparams, tcfg)
    loop.make_step(port, tcfg)(tparams, state, {"tokens": torch.from_numpy(toks)})
    tgrads = jax.tree_util.tree_map(lambda _, g: jnp.asarray(_np(g)), grads, seen["grads"])
    jp_same, jstate, _ = jopt.apply_updates(params, tgrads, jopt.init_state(params, jcfg), jcfg)

    want = {n: np.asarray(x) for n, x in flatten(jax.device_get(jp), "param").items()}
    same = {n: np.asarray(x) for n, x in flatten(jax.device_get(jp_same), "param").items()}
    jgrad = {n: np.asarray(x) for n, x in flatten(jax.device_get(grads), "param").items()}
    tgrad = {n: _np(x) for n, x in flatten(seen["grads"], "param").items()}
    for name, p in flatten(port.param_tree(), "param").items():
        scale = float(np.abs(jgrad[name]).max())
        np.testing.assert_allclose(tgrad[name], jgrad[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=name)
        got = _np(p)
        np.testing.assert_allclose(got, same[name], **OPT_TOL, err_msg=name)
        np.testing.assert_allclose(got, want[name], rtol=0, atol=2.2 * kw["lr"], err_msg=name)
        assert p.grad is None  # freed once applied
    for part in ("m", "v"):
        for name, x in flatten(state[part], part).items():
            np.testing.assert_allclose(_np(x), np.asarray(flatten(
                jax.device_get(jstate[part]), part)[name]), **OPT_TOL, err_msg=name)
    assert int(state["step"]) == 1


# ------------------------------------------------------------------ loop
def _loop(cls, adamw_cls, ckpt_dir, steps, ckpt_every=3, keep=3):
    return cls(steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, log_every=1000, keep=keep,
               adamw=adamw_cls(lr=3e-3, warmup_steps=2, total_steps=50))


def _port_tiny(jparams):
    model = build_model(_tiny(get_config), device="cpu")
    load_params(model, params_from_jax(jax.device_get(jparams)))
    return model


def _jax_run(dataset, ckpt_dir, steps, resume=False, seed=0, **loop):
    model = jax_build(_tiny(jax_config))
    loader = JaxLoader(JaxDataset(dataset), 8, seed=seed)
    return jax_train(model, loader,
                     _loop(JaxLoopConfig, jopt.AdamWConfig, ckpt_dir, steps, **loop),
                     resume=resume)


def _port_run(dataset, ckpt_dir, steps, resume=False, seed=0, hooks=None):
    jparams = jax_build(_tiny(jax_config)).init(jax.random.PRNGKey(0))
    loader = DataLoader(RaDataset(dataset), 8, seed=seed)
    return train(_port_tiny(jparams), loader,
                 _loop(TrainLoopConfig, topt.AdamWConfig, ckpt_dir, steps),
                 resume=resume, hooks=hooks)


def test_train_loop_gives_the_jax_losses(dataset, tmp_path):
    """Six steps from the same weights over the same batches: the straight
    run's first loss is JAX's (one state); from each of JAX's checkpoints
    1-4 (weights, moments, loader position) the port's loop takes two steps,
    whose first loss is JAX's of that step and whose second, after one
    update by the port (AdamW in its warmup and cosine schedule, the moments
    carried across), is JAX's of the next within ``_losses_close``'s
    one-step bound. The first update, from zero moments, is the most
    sign-like (up to 2.3e-5 apart after it, against 4.2e-7 after the later
    ones, at 1-8 threads): ``test_one_adamw_step_matches_jax`` holds its
    parameters."""
    jdir = tmp_path / "j"
    jout = _jax_run(dataset, str(jdir), 6, ckpt_every=1, keep=6)
    tout = _port_run(dataset, str(tmp_path / "t"), 6)
    assert tout["steps"] == 6 and latest_step(str(tmp_path / "t")) == 6
    assert np.mean(tout["losses"][-2:]) < np.mean(tout["losses"][:2])
    _losses_close(tout["losses"][:1], jout["losses"][:1])
    for k in range(1, 5):
        ck = tmp_path / f"from_{k}"
        shutil.copytree(jdir / f"step_{k:08d}", ck / f"step_{k:08d}")
        model = build_model(_tiny(get_config), device="cpu", seed=5)  # overwritten by the restore
        out = train(model, DataLoader(RaDataset(dataset), 8, seed=0),
                    _loop(TrainLoopConfig, topt.AdamWConfig, str(ck), k + 2), resume=True)
        assert out["steps"] == k + 2 and len(out["losses"]) == 2
        _losses_close(out["losses"], jout["losses"][k:k + 2])


def test_resume_continues_identically(dataset, tmp_path):
    """6 straight against 3 + resume + 3: equal final parameters."""
    straight = _port_run(dataset, str(tmp_path / "a"), 6)
    _port_run(dataset, str(tmp_path / "b"), 3)
    resumed = _port_run(dataset, str(tmp_path / "b"), 6, resume=True)
    assert resumed["steps"] == 6 and len(resumed["losses"]) == 3
    np.testing.assert_allclose(resumed["losses"], straight["losses"][3:], **RESUME_TOL)
    a, b = flatten(straight["params"], "param"), flatten(resumed["params"], "param")
    for name in a:
        np.testing.assert_allclose(_np(b[name]), _np(a[name]), **RESUME_TOL, err_msg=name)


def test_preemption_checkpoint_and_restart(dataset, tmp_path):
    """SIGTERM mid-run -> checkpoint flushed; restart resumes past it and
    continues the straight run's losses."""
    ck = str(tmp_path / "ck")
    sent = {"n": 0}

    def bomb(step, metrics):
        if step == 4 and not sent["n"]:
            sent["n"] = 1
            os.kill(os.getpid(), signal.SIGTERM)

    out = _port_run(dataset, ck, 50, hooks=[bomb])
    assert out["preempted"] and out["steps"] < 50
    saved = latest_step(ck)
    assert saved is not None and saved >= 4
    again = _port_run(dataset, ck, saved + 2, resume=True)
    assert again["steps"] == saved + 2 and not again["preempted"]
    straight = _port_run(dataset, str(tmp_path / "s"), saved + 2)
    np.testing.assert_allclose(again["losses"], straight["losses"][saved:], **RESUME_TOL)


def test_jax_checkpoint_resumes_in_the_port(dataset, tmp_path, capsys):
    """A checkpoint JAX's train() saved (params, optimizer state, loader
    position) resumes in the port and continues JAX's own losses."""
    ck = str(tmp_path / "ck")
    _jax_run(dataset, ck, 3)
    straight = _jax_run(dataset, str(tmp_path / "straight"), 6)
    model = build_model(_tiny(get_config), device="cpu", seed=5)  # overwritten by the restore
    out = train(model, DataLoader(RaDataset(dataset), 8, seed=0),
                _loop(TrainLoopConfig, topt.AdamWConfig, ck, 6), resume=True)
    assert "[train] resumed from step 3" in capsys.readouterr().out
    _losses_close(out["losses"], straight["losses"][3:])


def test_port_checkpoint_resumes_in_jax(dataset, tmp_path, capsys):
    """And the reverse: JAX resumes the port's checkpoint and continues the
    port's losses."""
    ck = str(tmp_path / "ck")
    _port_run(dataset, ck, 3)
    straight = _port_run(dataset, str(tmp_path / "straight"), 6)
    out = _jax_run(dataset, ck, 6, resume=True)
    assert "[train] resumed from step 3" in capsys.readouterr().out
    _losses_close(out["losses"], straight["losses"][3:])


# ---------------------------------------------------------- checkpoint manager
def test_checkpoint_manager_snapshots_and_keeps_the_last_k(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    w = torch.zeros(4)
    for step in (1, 2, 3):
        w.fill_(float(step))
        cm.save(step, {"w": w}, extra={"n": step})
        w.fill_(-1.0)  # the next step's in-place update: the save keeps its snapshot
    cm.wait()
    assert cm.latest() == 3
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000002", "step_00000003"]
    params, _, extra = load_checkpoint(cm.path(3), {"w": w})
    assert params["w"].tolist() == [3.0] * 4 and extra == {"n": 3}
    assert cm.save_s > 0


def test_checkpoint_manager_reraises_a_failed_save(tmp_path, monkeypatch):
    def fail(*a, **k):
        raise OSError("disk full")

    cm = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(tstore, "save_checkpoint", fail)
    cm.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    cm.wait()  # the error is handed over once


# ------------------------------------------------------------------ CLI
def test_cli_resumes_and_says_so(tmp_path, capsys):
    """``launch.train`` on the CPU with the device feed, then again as
    ``python -m repro_torch.launch.train`` with more steps: it resumes."""
    ds = str(tmp_path / "ds")
    make_token_dataset(ds, n_docs=32, seq_len=32, vocab=get_config("paper_lm").vocab,
                       shard_rows=16)
    work = str(tmp_path / "run")
    args = ["--device", "cpu", "--steps", "2", "--batch", "2", "--ckpt-every", "2",
            "--workdir", work, "--dataset", ds, "--device-feed"]
    assert train_main(args) == 0
    assert latest_step(os.path.join(work, "ckpt")) == 2
    args[3] = "3"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"),
         os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                         capture_output=True, text=True, timeout=120, env=env)
    assert run.returncode == 0, run.stderr
    assert "[train] resumed from step 2" in run.stdout
    assert latest_step(os.path.join(work, "ckpt")) == 3


def test_cli_run_returns_the_train_summary(tmp_path):
    """``launch.train.run`` trains as the CLI does and hands back ``train()``'s
    summary, so a caller reads the run's numbers without parsing its output."""
    ds = str(tmp_path / "ds")
    make_token_dataset(ds, n_docs=16, seq_len=32, vocab=get_config("paper_lm").vocab,
                       shard_rows=16)
    out = train_run(parse_args(["--device", "cpu", "--steps", "2", "--batch", "2",
                                "--ckpt-every", "2", "--workdir", str(tmp_path / "run"),
                                "--dataset", ds]))
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert out["cold_start"] is None and not out["preempted"]
    assert latest_step(str(tmp_path / "run" / "ckpt")) == 2
