"""The port's Mamba2 model and its serving path against the JAX package.

For the reduced ``mamba2_780m`` config in f32 the JAX params are carried into
the port (``convert.params_from_jax``), and the port's prefill logits and
cache (SSM state, conv tails, ``pos``), and several decode-step logits, are
held to the JAX model's within ``1e-4`` of each tensor's scale (the port
scans with ``ops.ssd_scan``, whose plain version sums in another order than
the JAX model's ``ssd_chunked``). The port's ``ServeEngine`` must give the
JAX engine's greedy tokens on a JAX-saved checkpoint, and a port-saved
Mamba2 checkpoint must restore through the JAX package bit for bit. The
consistency and chunk-invariance checks mirror ``tests/test_models.py``.

Training, at the same reduced config in f32, with the tolerances of
``tests/test_torch_train.py`` (its docstring gives their reasons): the
loss and metrics (``LOSS_TOL``) and every gradient leaf (``GRAD_TOL`` of
its largest entry) against ``jax.value_and_grad`` of the reference's
``train_loss``, with remat off and on (each layer under
``torch.utils.checkpoint``); one AdamW step against the reference's; the
train loop's losses against the JAX loop's; a port-saved train checkpoint
resumed by the JAX package and the reverse. The reference's value_and_grad
is jitted once per case for the module (``_jax_value_and_grad``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.checkpoint as jck
from repro.checkpoint.store import _leaf_name
from repro.configs import get_config as jax_config
from repro.data import DataLoader as JaxLoader
from repro.data import RaDataset as JaxDataset
from repro.distributed import optimizer as jopt
from repro.models import build_model as jax_build
from repro.serving import ServeEngine as JaxEngine
from repro.train import TrainLoopConfig as JaxLoopConfig
from repro.train import train as jax_train
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import get_config
from repro_torch.data import DataLoader, RaDataset, make_token_dataset
from repro_torch.distributed import optimizer as topt
from repro_torch.models import build_model
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.models.ssm_lm import Mamba2LM
from repro_torch.serving import ServeEngine
from repro_torch.serving.__main__ import main as serve_main
from repro_torch.train import TrainLoopConfig, train
from repro_torch.train.loop import make_step

TOL = 1e-4  # of each tensor's scale: rtol 1e-4, atol 1e-4 * max(1, max |want|)
ARCH = "mamba2_780m"
# training: tests/test_torch_train.py's tolerances, for its reasons
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
RUN_TOL = 1e-4
DRIFT_CAP = 3e-2


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _leaves(tree_or_model):
    if isinstance(tree_or_model, torch.nn.Module):
        tree_or_model = tree_or_model.param_tree()
    return {name: (tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1])
            for name, t in flatten(tree_or_model, "param").items()}


def _jax_leaves(tree):
    from repro.checkpoint.store import _leaf_name

    return {_leaf_name(path, "param"): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(seed=0, cfg_edit=None):
    """The reduced config's JAX model and params, and the port's model
    holding the same params."""
    jcfg = jax_config(ARCH).reduced()
    pcfg = get_config(ARCH).reduced()
    if cfg_edit:
        jcfg, pcfg = cfg_edit(jcfg), cfg_edit(pcfg)
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    port = build_model(pcfg, device="cpu")
    assert isinstance(port, Mamba2LM)
    assert _leaves(port) == _jax_leaves(params)
    load_params(port, params_from_jax(jax.device_get(params)))
    return jmodel, params, port


def test_full_mamba2_has_the_jax_leaf_names_and_shapes():
    jmodel = jax_build(jax_config(ARCH))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    port = build_model(get_config(ARCH), device="meta")
    assert _leaves(port) == _jax_leaves(shapes)
    n = sum(t.numel() for t in port.parameters())
    assert 0.7e9 < n < 0.8e9  # 780M in bf16: about 1.56 GB


def test_prefill_cache_and_decode_match_the_jax_model():
    jmodel, params, port = _pair()
    B, S, extra = 2, 64, 4  # two chunks of the reduced config's 32
    tokens = np.random.default_rng(7).integers(1, port.cfg.vocab, (B, S + extra)).astype(np.int32)

    jlogits, jcache = jax.jit(jmodel.prefill)(params, {"tokens": jnp.asarray(tokens[:, :S])})
    tlogits, tcache = port.prefill(torch.from_numpy(tokens[:, :S]).long())
    _close(tlogits, jlogits)
    for key in ("ssm", "conv_x", "conv_B", "conv_C"):
        assert tuple(tcache[key].shape) == tuple(jcache[key].shape), key
        _close(tcache[key], jcache[key])
    assert tcache["pos"].dtype == torch.int32 and tcache["pos"].dim() == 0
    assert int(tcache["pos"]) == int(jcache["pos"]) == S

    step = jax.jit(jmodel.decode_step)
    for t in range(S, S + extra):
        jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = port.decode_step(tcache, torch.from_numpy(tokens[:, t:t + 1]).long())
        _close(tl, jl)
    for key in ("ssm", "conv_x", "conv_B", "conv_C"):
        _close(tcache[key], jcache[key])
    assert int(tcache["pos"]) == S + extra


def test_prefill_decode_consistency():
    """Mirrors tests/test_models.py:63-78 on the port alone."""
    port = build_model(get_config(ARCH).reduced(), device="cpu", seed=1)
    B, S = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(2).integers(1, port.cfg.vocab, (B, S)))
    logits_pf, _ = port.prefill(tokens)
    cache = port.empty_cache(B, S + 4)
    for t in range(S):
        logits_dec, cache = port.decode_step(cache, tokens[:, t:t + 1])
    np.testing.assert_allclose(_np(logits_pf), _np(logits_dec), rtol=2e-3, atol=2e-4)


def test_ssd_chunk_invariance():
    """Mirrors tests/test_models.py:136-151: the output does not depend on
    the chunk size (an algebraic identity)."""
    cfg = get_config(ARCH).reduced()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab, (2, 64)))
    outs = []
    for chunk in (16, 32, 64):
        c = cfg.with_(ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
        logits, _ = build_model(c, device="cpu", seed=0).prefill(tokens)
        outs.append(_np(logits))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-4, atol=1e-5)


def test_short_prompt_keeps_the_conv_padding():
    """A prompt shorter than the conv's reach (conv_width - 1 = 3) leaves
    zeros before its tail, as the causal conv's padding; decoding on from
    it equals decoding the prompt token by token."""
    port = build_model(get_config(ARCH).reduced(), device="cpu", seed=3)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(1, port.cfg.vocab, (2, 2)))
    _, cache = port.prefill(tokens)
    assert torch.equal(cache["conv_x"][:, :, 0], torch.zeros_like(cache["conv_x"][:, :, 0]))
    ref = port.empty_cache(2)
    for t in range(2):
        _, ref = port.decode_step(ref, tokens[:, t:t + 1])
    nxt = tokens[:, :1]
    got, _ = port.decode_step(cache, nxt)
    want, _ = port.decode_step(ref, nxt)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-4)


def test_serve_engine_matches_the_jax_engine(tmp_path):
    cfg = jax_config(ARCH).reduced()
    jmodel = jax_build(cfg)
    params = jmodel.init(jax.random.PRNGKey(3))
    path = jck.save_checkpoint(str(tmp_path), 1, params)
    prompts = np.random.default_rng(4).integers(1, cfg.vocab, (2, 64)).astype(np.int32)
    want = JaxEngine(jmodel, checkpoint=path).generate(prompts, max_new=8)

    pcfg = get_config(ARCH).reduced()
    for restore in ("pipelined", "naive"):
        engine = ServeEngine(build_model(pcfg, device="meta"), checkpoint=path,
                             restore=restore, device="cpu")
        got = engine.generate(prompts, max_new=8)
        assert got.dtype == np.int32 and got.shape == (2, 8)
        np.testing.assert_array_equal(got, want)
        assert engine.cold_start.leaves == len(_jax_leaves(params))
        assert engine.throughput()["tokens"] == 16


def test_port_checkpoint_restores_through_the_jax_package(tmp_path):
    _, params, port = _pair(seed=5)
    path = save_checkpoint(str(tmp_path), 2, port.param_tree())
    like = jax.tree_util.tree_map(lambda a: np.empty(a.shape, a.dtype), jax.device_get(params))
    got, _, _ = jck.load_checkpoint(path, like)
    want = jax.device_get(params)
    for (gp, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                               jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(gp))


def test_serving_cli_routes_the_ssm_arch(monkeypatch, capsys):
    real = tconfigs.get_config
    monkeypatch.setattr(tconfigs, "get_config", lambda arch: real(arch).reduced())
    serve_main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt", "16",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "random init" in out and "generated (2, 3) tokens" in out


# ------------------------------------------------------------------ training
@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(remat: bool):
    """The reduced reference, its params and its jitted value_and_grad of
    ``train_loss``: compiled once for the module's tests."""
    jmodel = jax_build(jax_config(ARCH).reduced().with_(remat=remat))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    fn = jax.jit(jax.value_and_grad(
        lambda p, toks: jmodel.train_loss(p, {"tokens": toks}), has_aux=True))
    return jmodel, params, fn


def _trainable(params, remat=False):
    port = build_model(get_config(ARCH).reduced().with_(remat=remat), device="cpu")
    load_params(port, params_from_jax(jax.device_get(params)))
    return port.requires_grad_(True)


def _train_tokens(vocab, B=2, S=64, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.uint32)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_train_loss_and_grads_match_jax(remat):
    """Two chunks of 32 a sequence: the loss, its metrics and all 19 gradient
    leaves against the reference's."""
    _, params, fn = _jax_value_and_grad(remat)
    port = _trainable(params, remat)
    toks = _train_tokens(port.cfg.vocab)
    (jl, jmet), jg = fn(params, jnp.asarray(toks.astype(np.int32)))
    loss, met = port.train_loss({"tokens": torch.from_numpy(toks)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_TOL)
    assert set(met) == set(jmet) == {"ce", "aux", "acc", "loss"}
    for key in met:
        np.testing.assert_allclose(float(met[key].detach()), float(jmet[key]), rtol=LOSS_TOL, atol=1e-7)
    want = {name: np.asarray(g) for name, g in flatten(jax.device_get(jg), "param").items()}
    got = {name: p.grad for name, p in flatten(port.param_tree(), "param").items()}
    assert set(got) == set(want) and len(want) == 19
    for name, g in want.items():
        assert got[name] is not None and got[name].any(), name
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(_np(got[name].detach()), g, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=name)


def test_one_adamw_step_matches_jax():
    """From the same parameters and batch, one step of each package, at the
    config's f32 moments (tests/test_torch_train.py's first-step rule: an
    entry whose gradient is within the gradient tolerance of zero may step
    the other way, up to 2·lr)."""
    jmodel, params, fn = _jax_value_and_grad(False)
    port = _trainable(params)
    toks = _train_tokens(port.cfg.vocab, seed=1)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10, moment_dtype=port.cfg.opt_moment_dtype)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    (_, _), grads = fn(params, jnp.asarray(toks.astype(np.int32)))
    jp, _, _ = jax.jit(lambda p, g, st: jopt.apply_updates(p, g, st, jcfg))(
        params, grads, jopt.init_state(params, jcfg))
    tparams = port.param_tree()
    state = topt.init_state(tparams, tcfg)
    make_step(port, tcfg)(tparams, state, {"tokens": torch.from_numpy(toks)})
    want = {n: np.asarray(x) for n, x in flatten(jax.device_get(jp), "param").items()}
    grad = {n: np.abs(np.asarray(x)) for n, x in flatten(jax.device_get(grads), "param").items()}
    for name, p in flatten(port.param_tree(), "param").items():
        got = _np(p.detach())
        np.testing.assert_allclose(got, want[name], rtol=0, atol=2.2 * kw["lr"], err_msg=name)
        off = ~np.isclose(got, want[name], rtol=RUN_TOL, atol=1e-6)
        assert (grad[name][off] <= GRAD_TOL * grad[name].max()).all(), name
        assert p.grad is None
    assert int(state["step"]) == 1


def test_optimizer_state_has_the_jax_leaf_names():
    """The AdamW state's checkpoint leaves (``opt__m__layers__ssm__...``) at
    the config's moments have the reference's names, shapes and dtypes."""
    cfg = jax_config(ARCH).reduced()
    jmodel = jax_build(cfg)
    moments = get_config(ARCH).opt_moment_dtype
    js = jax.eval_shape(lambda: jopt.init_state(jmodel.init(jax.random.PRNGKey(0)),
                                                jopt.AdamWConfig(moment_dtype=moments)))
    want = {_leaf_name(path, "opt"): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(js)[0]}
    port = build_model(get_config(ARCH).reduced(), device="cpu")
    ts = topt.init_state(port.param_tree(), topt.AdamWConfig(moment_dtype=moments))
    got = {name: (tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1])
           for name, t in flatten(ts, "opt").items()}
    assert got == want and moments == "float32"


@pytest.fixture(scope="module")
def token_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mamba_train") / "ds")
    make_token_dataset(root, n_docs=64, seq_len=64, vocab=512, shard_rows=32)
    return root


def _loop(cls, adamw_cls, ckpt_dir, steps):
    return cls(steps=steps, ckpt_every=3, ckpt_dir=ckpt_dir, log_every=1000,
               adamw=adamw_cls(lr=3e-3, warmup_steps=2, total_steps=50))


def _jax_run(ds, ckpt_dir, steps, resume=False):
    model = jax_build(jax_config(ARCH).reduced())
    return jax_train(model, JaxLoader(JaxDataset(ds), 4, seed=0),
                     _loop(JaxLoopConfig, jopt.AdamWConfig, ckpt_dir, steps), resume=resume)


def _port_run(ds, ckpt_dir, steps, resume=False):
    jparams = jax_build(jax_config(ARCH).reduced()).init(jax.random.PRNGKey(0))
    model = build_model(get_config(ARCH).reduced(), device="cpu")
    load_params(model, params_from_jax(jax.device_get(jparams)))
    return train(model, DataLoader(RaDataset(ds), 4, seed=0),
                 _loop(TrainLoopConfig, topt.AdamWConfig, ckpt_dir, steps), resume=resume)


def _losses_close(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        tol = min(LOSS_TOL * 10 ** k, DRIFT_CAP)
        assert abs(g - w) <= tol * abs(w), f"step {k}: {g} vs {w} (rtol {tol})"


@pytest.fixture(scope="module")
def straight_runs(token_dataset, tmp_path_factory):
    """Five steps of each package's ``train()`` from the same weights over
    the same batches (4 × 64 tokens), each with checkpoints every 3 steps."""
    root = tmp_path_factory.mktemp("mamba_straight")
    return {"jax": _jax_run(token_dataset, str(root / "j"), 5),
            "port": _port_run(token_dataset, str(root / "t"), 5), "root": root}


def test_train_loop_gives_the_jax_losses(straight_runs):
    _losses_close(straight_runs["port"]["losses"], straight_runs["jax"]["losses"])
    assert straight_runs["port"]["steps"] == 5
    assert latest_step(str(straight_runs["root"] / "t")) == 5


def test_train_checkpoints_resume_across_the_packages(token_dataset, straight_runs, tmp_path,
                                                      capsys):
    """A train checkpoint the port saved at step 3 (params, f32 moments, the
    loader's place) resumes in the JAX package and continues the port's own
    losses; one the JAX package saved resumes in the port and continues the
    reference's."""
    _port_run(token_dataset, str(tmp_path / "p"), 3)
    jout = _jax_run(token_dataset, str(tmp_path / "p"), 5, resume=True)
    assert "[train] resumed from step 3" in capsys.readouterr().out
    _losses_close(jout["losses"], straight_runs["port"]["losses"][3:])

    _jax_run(token_dataset, str(tmp_path / "j"), 3)
    tout = _port_run(token_dataset, str(tmp_path / "j"), 5, resume=True)
    assert "[train] resumed from step 3" in capsys.readouterr().out
    _losses_close(tout["losses"], straight_runs["jax"]["losses"][3:])


def test_train_cli_routes_the_ssm_arch(monkeypatch, tmp_path, capsys):
    """``launch.train --arch mamba2_780m`` trains through the same loop, AdamW
    and checkpoints as the dense family (the config reduced, as the serving
    CLI's test reduces it), and resumes."""
    from repro_torch.launch.train import main as train_main

    real = tconfigs.get_config
    monkeypatch.setattr(tconfigs, "get_config", lambda arch: real(arch).reduced())
    work = str(tmp_path / "run")
    args = ["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "2",
            "--ckpt-every", "2", "--workdir", work]
    assert train_main(args) == 0
    assert latest_step(str(tmp_path / "run" / "ckpt")) == 2
    args[5] = "3"
    assert train_main(args) == 0
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert latest_step(str(tmp_path / "run" / "ckpt")) == 3
