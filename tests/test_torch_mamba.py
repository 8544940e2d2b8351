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
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.checkpoint as jck
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serving import ServeEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.models.ssm_lm import Mamba2LM
from repro_torch.serving import ServeEngine
from repro_torch.serving.__main__ import main as serve_main

TOL = 1e-4  # of each tensor's scale: rtol 1e-4, atol 1e-4 * max(1, max |want|)
ARCH = "mamba2_780m"


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
