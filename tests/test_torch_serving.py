"""The port's dense model and serving path against the JAX package.

Configs are compared field for field. For five reduced dense configs in f32
(InternLM2; Qwen2.5 with qkv bias and padded heads; Gemma3 with window /
global layers, sandwich norms, embed scale and qk-norm; OLMo with
non-parametric LayerNorm and tied embeddings; paper_lm) the JAX params are
carried into the port (``convert.params_from_jax``) and the port's prefill
logits and cache, and several decode-step logits, are held to the JAX
model's within ``1e-4`` of each tensor's scale (f32 throughout; the port
runs the attention kernels' plain versions on the CPU; the sums, and RoPE's
sin/cos at angles up to ~80 rad, round differently in the two packages). The port's ``ServeEngine``
must give the JAX engine's greedy tokens on the same checkpoint.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import save_checkpoint as jax_save
from repro.checkpoint.store import _leaf_name
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serving import ServeEngine as JaxEngine
from repro_torch.checkpoint import save_checkpoint
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.spec import RawArrayError
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.models import build_model
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.serving import ServeEngine
from repro_torch.serving.__main__ import main as serve_main

TOL = 1e-4  # of each tensor's scale: rtol 1e-4, atol 1e-4 * max(1, max |want|)
DENSE = ["internlm2_1_8b", "qwen2_5_14b", "gemma3_12b", "olmo_1b", "paper_lm"]
# reduced configs with a field changed: gemma3 at its own head width (256), which
# the reduced config (head_dim 32) does not reach
VARIANTS = {"gemma3_12b_hd256": ("gemma3_12b", {"head_dim": 256})}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_the_jax_package(arch):
    assert ARCH_IDS == JAX_ARCH_IDS
    port, ref = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert str(port.pdtype).rsplit(".", 1)[-1] == ref.param_dtype


def _leaves_of_jax(tree):
    return {_leaf_name(path, "param"): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _leaves_of_port(model):
    return {name: (tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1])
            for name, t in flatten(model.param_tree(), "param").items()}


def test_full_internlm2_has_the_jax_leaf_names_and_shapes():
    cfg = get_config("internlm2_1_8b")
    jmodel = jax_build(jax_config("internlm2_1_8b"))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    port = build_model(cfg, device="meta")
    assert _leaves_of_port(port) == _leaves_of_jax(shapes)
    assert sum(t.numel() for t in port.parameters()) == 1_889_110_016  # 3.8 GB in bf16


def _pair(arch, seed=0):
    """The reduced config's JAX model and params, and the port's model
    holding the same params (``arch`` may name one of ``VARIANTS``)."""
    arch, changes = VARIANTS.get(arch, (arch, {}))
    jcfg = jax_config(arch).reduced().with_(**changes)
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    port = build_model(get_config(arch).reduced().with_(**changes), device="cpu")
    assert _leaves_of_port(port) == _leaves_of_jax(params)
    load_params(port, params_from_jax(jax.device_get(params)))
    return jmodel, params, port


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want):
    got, want = _np(got), _np(want)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=atol)


@pytest.mark.parametrize("arch", DENSE + list(VARIANTS))
def test_prefill_and_decode_match_the_jax_model(arch):
    jmodel, params, port = _pair(arch)
    cfg = port.cfg
    B, S, extra = 2, 80, 3  # S > the reduced window (64): gemma3's local layers mask
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg.vocab, (B, S + extra)).astype(np.int32)
    padded = tokens.copy()
    padded[:, S:] = 0

    jlogits, jcache = jax.jit(jmodel.prefill)(params, {"tokens": jnp.asarray(padded)})
    tlogits, tcache = port.prefill(torch.from_numpy(padded).long())
    _close(tlogits, jlogits)
    for kv in ("k", "v"):
        _close(tcache["dense"][kv], jcache["dense"][kv])
    assert int(tcache["pos"]) == int(jcache["pos"]) == S + extra

    # rewind to S and decode the held-back tokens over the padding
    jcache["pos"] = jnp.asarray(S, jnp.int32)
    tcache["pos"] = torch.tensor(S, dtype=torch.int32)
    step = jax.jit(jmodel.decode_step)
    for t in range(S, S + extra):
        jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = port.decode_step(tcache, torch.from_numpy(tokens[:, t:t + 1]).long())
        _close(tl, jl)
    assert int(tcache["pos"]) == S + extra


def test_served_dense_configs_fit_the_attention_kernels():
    """Every dense config the port serves has a head width the CUDA attention
    kernels are instantiated for: the card must serve what the CPU serves."""
    served = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.family != "dense":
            continue
        try:
            build_model(cfg.reduced(), device="meta")
        except NotImplementedError:
            continue
        served.append(arch)
        pair = (cfg.head_dim, cfg.head_dim)
        assert pair in flash_attention.HEAD_DIMS[cfg.cdtype], (arch, cfg.head_dim)
        assert pair in decode_attention.HEAD_DIMS[cfg.cdtype], (arch, cfg.head_dim)
    assert set(DENSE) <= set(served)


def test_served_moe_configs_fit_the_attention_kernels():
    """The moe family's attention widths are instantiated in its dtype:
    Kimi-K2's 112 in both kernels; DeepSeek-V3's MLA prefill (q·k = nope +
    rope, v) in the flash kernel and its absorbed decode (latent + rope over
    the latent, read from the same rows) in the decode kernel."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.family != "moe":
            continue
        build_model(cfg.reduced(), device="meta")  # the family builds
        if cfg.attn_type == "mla":
            m = cfg.mla
            prefill = (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim)
            decode = (m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank)
            assert decode in decode_attention.SHARED_ROWS, arch
        else:
            prefill = decode = (cfg.head_dim, cfg.head_dim)
        assert prefill in flash_attention.HEAD_DIMS[cfg.cdtype], (arch, prefill)
        assert prefill in flash_attention.BWD_HEAD_DIMS[cfg.cdtype], (arch, prefill)  # training
        assert decode in decode_attention.HEAD_DIMS[cfg.cdtype], (arch, decode)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "qwen2_5_14b", "gemma3_12b"])
def test_prefill_decode_consistency(arch):
    """Mirrors tests/test_models.py:63-78 on the port alone."""
    port = build_model(get_config(arch).reduced(), device="cpu", seed=1)
    B, S = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(2).integers(1, port.cfg.vocab, (B, S)))
    logits_pf, _ = port.prefill(tokens)
    cache = port.empty_cache(B, S + 4)
    for t in range(S):
        logits_dec, cache = port.decode_step(cache, tokens[:, t:t + 1])
    np.testing.assert_allclose(_np(logits_pf), _np(logits_dec), rtol=2e-3, atol=2e-4)


def test_serve_engine_matches_the_jax_engine(tmp_path):
    cfg = jax_config("internlm2_1_8b").reduced()
    jmodel = jax_build(cfg)
    params = jmodel.init(jax.random.PRNGKey(3))
    path = jax_save(str(tmp_path), 1, params)
    prompts = np.random.default_rng(4).integers(1, cfg.vocab, (2, 16)).astype(np.int32)
    want = JaxEngine(jmodel, checkpoint=path).generate(prompts, max_new=8)

    pcfg = get_config("internlm2_1_8b").reduced()
    for restore in ("pipelined", "naive"):
        engine = ServeEngine(build_model(pcfg, device="meta"), checkpoint=path,
                             restore=restore, device="cpu")
        got = engine.generate(prompts, max_new=8)
        assert got.dtype == np.int32 and got.shape == (2, 8)
        np.testing.assert_array_equal(got, want)
        assert engine.cold_start.leaves == len(_leaves_of_jax(params))
        stats = engine.throughput()
        assert stats["tokens"] == 16 and stats["decode_tok_per_s"] > 0

    sampled = engine.generate(prompts, max_new=4, temperature=1.0, seed=5)
    assert sampled.shape == (2, 4) and (0 <= sampled).all() and (sampled < cfg.vocab).all()


def test_port_checkpoint_serves_the_same_tokens(tmp_path):
    """A port checkpoint, raw and u8, restores into a model on the meta
    device and serves; raw gives the source model's tokens."""
    src = build_model(get_config("paper_lm").reduced(), device="cpu", seed=6)
    prompts = np.random.default_rng(8).integers(1, src.cfg.vocab, (2, 12)).astype(np.int32)
    want = ServeEngine(src).generate(prompts, max_new=6)
    for step, kw in ((1, {}), (2, {"quantize": "u8"})):
        path = save_checkpoint(str(tmp_path), step, src.param_tree(), **kw)
        engine = ServeEngine(build_model(src.cfg, device="meta"), checkpoint=path, device="cpu")
        got = engine.generate(prompts, max_new=6)
        if not kw:
            np.testing.assert_array_equal(got, want)
        assert engine.cold_start.dequant_leaves == (len(list(src.parameters())) if kw else 0)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("paper_lm").reduced()
    with pytest.raises(RawArrayError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RawArrayError, match="no CUDA device"):
        ServeEngine(build_model(cfg, device="meta"))
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_serving_cli_runs_random_and_from_a_checkpoint(tmp_path, capsys):
    serve_main(["--arch", "paper_lm", "--device", "cpu", "--batch", "2", "--max-new", "3"])
    model = build_model(get_config("paper_lm"), device="cpu")
    save_checkpoint(os.path.join(tmp_path, "ckpt"), 5, model.param_tree())
    serve_main(["--arch", "paper_lm", "--device", "cpu", "--workdir", str(tmp_path),
                "--batch", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "random init" in out and "restoring checkpoint" in out and "step_00000005" in out
