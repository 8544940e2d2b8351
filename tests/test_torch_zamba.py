"""The port's Zamba2 model (the hybrid family) and its serving path against
the JAX package.

For the reduced ``zamba2_1_2b`` config in f32 (4 Mamba2 layers, the shared
block after every 2nd, a shared head width of 64) the JAX params are
carried into the port (``convert.params_from_jax``), and the port's prefill
logits and cache (SSM states, conv tails, the shared attention's K and V,
``pos``), and several decode-step logits after it, are held to the JAX
model's within ``1e-4`` of each tensor's scale; one case runs at
``reduced().with_(d_model=256)``, whose shared head width is the full
model's 128. The shared attention's projections are tempered to their
contraction width first (``_temper``): at the reference's init scales the
block's softmax is all but an argmax, and the two packages' f32 roundings
then move logits by more than the tolerance. The port's ``ServeEngine``, which replays the prompt through
``decode_step`` as the JAX engine does, must give the JAX engine's greedy
tokens on a JAX-saved checkpoint, and a port-saved Zamba2 checkpoint must
restore through the JAX package bit for bit. The prefill/replay
consistency check mirrors ``tests/test_models.py:63-78``.
"""

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
from repro_torch.models.ssm_lm import Zamba2LM
from repro_torch.serving import ServeEngine
from repro_torch.serving.__main__ import main as serve_main

TOL = 1e-4  # of each tensor's scale: rtol 1e-4, atol 1e-4 * max(1, max |want|)
ARCH = "zamba2_1_2b"
SSM_KEYS = ("ssm", "conv_x", "conv_B", "conv_C")
WIDE = {"reduced": None, "shared_hd128": lambda c: c.with_(d_model=256)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, tol=TOL, err_msg=""):
    got, want = _np(got), _np(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=err_msg)


def _leaves(tree_or_model):
    if isinstance(tree_or_model, torch.nn.Module):
        tree_or_model = tree_or_model.param_tree()
    return {name: (tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1])
            for name, t in flatten(tree_or_model, "param").items()}


def _jax_leaves(tree):
    from repro.checkpoint.store import _leaf_name

    return {_leaf_name(path, "param"): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _temper(params, cfg):
    """The JAX params with the shared attention's projections scaled to
    their contraction width, as ``chip_smoke.py:_temper_attention`` scales
    the card's models. At the reference's init scales (``fanin`` divides by
    the head count) the shared block's scores have a std near 64 at the
    reduced widths and its softmax is all but an argmax, so a change of
    about one f32 rounding in a state can move some logits by more than
    ``TOL`` of their scale, in either package. Tempered, the scores have a
    std near 1."""
    attn = dict(params["shared"]["attn"])
    width, H, KV = 2 * cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    for name, factor in (("wq", H / width), ("wk", KV / width), ("wv", KV / width),
                         ("wo", 1 / H)):
        attn[name] = attn[name] * factor ** 0.5
    return {**params, "shared": {**params["shared"], "attn": attn}}


def _pair(seed=0, cfg_edit=None):
    """The reduced config's JAX model and params (the shared attention
    tempered), and the port's model holding the same params."""
    jcfg = jax_config(ARCH).reduced()
    pcfg = get_config(ARCH).reduced()
    if cfg_edit:
        jcfg, pcfg = cfg_edit(jcfg), cfg_edit(pcfg)
    jmodel = jax_build(jcfg)
    params = _temper(jmodel.init(jax.random.PRNGKey(seed)), jcfg)
    port = build_model(pcfg, device="cpu")
    assert isinstance(port, Zamba2LM)
    assert _leaves(port) == _jax_leaves(params)
    load_params(port, params_from_jax(jax.device_get(params)))
    return jmodel, params, port


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(np.int32)


def test_full_zamba2_has_the_jax_leaf_names_and_shapes():
    jmodel = jax_build(jax_config(ARCH))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    port = build_model(get_config(ARCH), device="meta")
    assert _leaves(port) == _jax_leaves(shapes)
    n = sum(t.numel() for t in port.parameters())
    assert 1.0e9 < n < 1.4e9  # 1.2B in bf16: about 2.4 GB


def test_invocations_and_cache_layout_match_the_jax_model():
    """The full model: the shared block after layers 5, 11, ..., 35 (6
    invocations over 38 layers), and the empty cache's nested layout,
    shapes and dtypes are the JAX model's."""
    jmodel = jax_build(jax_config(ARCH))
    port = build_model(get_config(ARCH), device="meta")
    assert port.invocations == jmodel.invocations == [5, 11, 17, 23, 29, 35]
    assert port._segments() == jmodel._segments()
    assert port.attn_cfg.head_dim == jmodel.attn_cfg.head_dim == 128
    want = jax.eval_shape(lambda: jmodel.empty_cache(8, 288))
    got = port.empty_cache(8, 288)
    assert set(got) == set(want) == {"ssm", "attn", "pos"}
    for group in ("ssm", "attn"):
        assert set(got[group]) == set(want[group])
        for key, w in want[group].items():
            t = got[group][key]
            assert (tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1]) == \
                (tuple(w.shape), str(w.dtype)), (group, key)
    assert got["pos"].dim() == 0 and got["pos"].dtype == torch.int32


@pytest.mark.parametrize("width", list(WIDE))
def test_prefill_and_cache_match_the_jax_model(width):
    jmodel, params, port = _pair(cfg_edit=WIDE[width])
    B, S = 2, 64  # two chunks of the reduced config's 32
    tokens = _tokens(port.cfg.vocab, B, S, 7)
    jlogits, jcache = jax.jit(jmodel.prefill)(params, {"tokens": jnp.asarray(tokens)})
    tlogits, tcache = port.prefill(torch.from_numpy(tokens).long())
    _close(tlogits, jlogits)
    for group, keys in (("ssm", SSM_KEYS), ("attn", ("k", "v"))):
        for key in keys:
            got, want = tcache[group][key], jcache[group][key]
            assert tuple(got.shape) == tuple(want.shape), (group, key)
            _close(got, want, err_msg=f"{group}.{key}")
    assert tcache["pos"].dtype == torch.int32 and tcache["pos"].dim() == 0
    assert int(tcache["pos"]) == int(jcache["pos"]) == S


def _grow_jax(cache, capacity):
    """A JAX prefill's cache with the K/V (length S) zero-padded to ``capacity``."""
    pad = lambda a: jnp.pad(a, [(0, 0)] * 3 + [(0, capacity - a.shape[3]), (0, 0)])
    return {**cache, "attn": {k: pad(a) for k, a in cache["attn"].items()}}


def _grow_port(cache, capacity):
    """The port's prefill cache with the K/V (length S) zero-padded to ``capacity``."""
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, capacity - t.shape[3]))
    return {**cache, "attn": {k: pad(t) for k, t in cache["attn"].items()}}


@pytest.mark.parametrize("width", list(WIDE))
def test_decode_after_prefill_matches_the_jax_model(width):
    """Prefill S tokens, move the K/V into caches of capacity S + extra (as
    the prefill's own caches end at S), then decode ``extra`` tokens."""
    jmodel, params, port = _pair(seed=1, cfg_edit=WIDE[width])
    B, S, extra = 2, 32, 4
    tokens = _tokens(port.cfg.vocab, B, S + extra, 8)
    _, jcache = jax.jit(jmodel.prefill)(params, {"tokens": jnp.asarray(tokens[:, :S])})
    _, tcache = port.prefill(torch.from_numpy(tokens[:, :S]).long())
    jcache, tcache = _grow_jax(jcache, S + extra), _grow_port(tcache, S + extra)
    step = jax.jit(jmodel.decode_step)
    for t in range(S, S + extra):
        jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = port.decode_step(tcache, torch.from_numpy(tokens[:, t:t + 1]).long())
        _close(tl, jl, err_msg=f"step {t}")
    for key in SSM_KEYS:
        _close(tcache["ssm"][key], jcache["ssm"][key], err_msg=key)
    for key in ("k", "v"):
        _close(tcache["attn"][key], jcache["attn"][key], err_msg=key)
    assert int(tcache["pos"]) == S + extra


def test_prefill_decode_consistency():
    """Mirrors tests/test_models.py:63-78 on the port alone: the prefill's
    last logits and a token-by-token replay's."""
    port = build_model(get_config(ARCH).reduced(), device="cpu", seed=1)
    B, S = 2, 16
    tokens = torch.from_numpy(_tokens(port.cfg.vocab, B, S, 2)).long()
    logits_pf, _ = port.prefill(tokens)
    cache = port.empty_cache(B, S + 4)
    for t in range(S):
        logits_dec, cache = port.decode_step(cache, tokens[:, t:t + 1])
    np.testing.assert_allclose(_np(logits_pf), _np(logits_dec), rtol=2e-3, atol=2e-4)


def test_short_prompt_keeps_the_conv_padding():
    """A prompt shorter than the conv's reach (conv_width - 1 = 3) leaves
    zeros before its tail; decoding on from its prefill (K/V grown to room)
    equals decoding the prompt token by token."""
    port = build_model(get_config(ARCH).reduced(), device="cpu", seed=3)
    tokens = torch.from_numpy(_tokens(port.cfg.vocab, 2, 2, 4)).long()
    _, cache = port.prefill(tokens)
    conv = cache["ssm"]["conv_x"]
    assert torch.equal(conv[:, :, 0], torch.zeros_like(conv[:, :, 0]))
    cache = _grow_port(cache, 3)
    ref = port.empty_cache(2, 3)
    for t in range(2):
        _, ref = port.decode_step(ref, tokens[:, t:t + 1])
    got, _ = port.decode_step(cache, tokens[:, :1])
    want, _ = port.decode_step(ref, tokens[:, :1])
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-4)


def test_serve_engine_matches_the_jax_engine(tmp_path):
    cfg = jax_config(ARCH).reduced()
    jmodel = jax_build(cfg)
    params = _temper(jmodel.init(jax.random.PRNGKey(3)), cfg)
    path = jck.save_checkpoint(str(tmp_path), 1, params)
    prompts = _tokens(cfg.vocab, 2, 32, 4)
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


def test_serving_cli_routes_the_hybrid_arch(monkeypatch, capsys):
    real = tconfigs.get_config
    monkeypatch.setattr(tconfigs, "get_config", lambda arch: real(arch).reduced())
    serve_main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt", "16",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert "random init" in out and "generated (2, 3) tokens" in out


def test_train_loss_names_its_roadmap_item():
    model = build_model(get_config(ARCH).reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        model.train_loss({"tokens": torch.zeros(1, 8, dtype=torch.int64)})
