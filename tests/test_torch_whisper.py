"""The port's Whisper model (the encdec family) against the JAX package.

For the reduced ``whisper_medium`` config in f32 (2 encoder and 2 decoder
layers, 4 heads of 32, 64 encoder positions) the JAX params are carried into
the port (``convert.params_from_jax``), and the port's ``encode``,
``prefill`` logits and whole cache (k, v, ck, cv, ``pos``), eight
``decode_step`` logits after it, and the greedy tokens of the serving loop
(the JAX engine's algorithm for attention families: prefill the prompt
right-padded to its capacity, rewind ``pos``, decode) are held to the JAX
model's within ``1e-4`` of each tensor's scale (``tests/test_torch_serving.py``'s
``TOL``). The attention projections are tempered to their contraction width
first (``_temper``), as ``chip_smoke.py`` tempers the card's models: at the
reference's init scales the scores' softmax is all but an argmax, and the
two packages' f32 roundings then move some outputs past the tolerance.

The JAX model computes attention in query chunks of 512 and drops the
remainder (``src/repro/models/whisper.py:48``), so it raises at 600 frames
(and at its config's 1,500): ``test_reference_encoder_fails_past_a_chunk``
shows it, and the 600-frame comparison runs the reference with its
``_attn`` patched to one chunk of Sq rows, the exact full attention. The
JAX ``ServeEngine`` cannot serve this family (its prefill passes no frames),
and the port's engine says so.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.checkpoint as jck
import repro.models.whisper as jwhisper
from repro.checkpoint.store import _leaf_name
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serving import ServeEngine as JaxEngine
from repro_torch.checkpoint import load_checkpoint, restore_pipelined, save_checkpoint
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.models.whisper import WhisperModel
from repro_torch.serving import ServeEngine
from repro_torch.serving.__main__ import main as serve_main

TOL = 1e-4  # of each tensor's scale: rtol 1e-4, atol 1e-4 * max(1, max |want|)
BF16_TOL = 2e-2  # bf16 activations: the attention kernels' bf16 tolerance (test_kernels.py:19)
ARCH = "whisper_medium"
ATTN = {"enc_layers": ("attn",), "dec_layers": ("self_attn", "cross_attn")}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, err_msg="", tol=TOL):
    got, want = _np(got), _np(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=err_msg)


def _leaves(model):
    return {name: (tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1])
            for name, t in flatten(model.param_tree(), "param").items()}


def _jax_leaves(tree):
    return {_leaf_name(path, "param"): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _temper(params, cfg):
    """The JAX params with every attention's projections scaled to their
    contraction width (``chip_smoke.py:_temper_attention``): ``fanin``
    divides ``(d, H, hd)`` weights by H, so the scores' std is near
    sqrt(d) at these widths; tempered, near 1."""
    d, H = cfg.d_model, cfg.n_heads
    out = dict(params)
    for stack, kinds in ATTN.items():
        layers = dict(params[stack])
        for kind in kinds:
            a = dict(layers[kind])
            for name, factor in (("wq", H / d), ("wk", H / d), ("wv", H / d), ("wo", 1 / H)):
                a[name] = a[name] * factor ** 0.5
            layers[kind] = a
        out[stack] = layers
    return out


def _pair(seed=0, **changes):
    """The reduced config's JAX model and params (tempered), and the port's
    model holding the same params."""
    jcfg = jax_config(ARCH).reduced().with_(**changes)
    jmodel = jax_build(jcfg)
    params = _temper(jmodel.init(jax.random.PRNGKey(seed)), jcfg)
    port = build_model(get_config(ARCH).reduced().with_(**changes), device="cpu")
    assert isinstance(port, WhisperModel)
    assert _leaves(port) == _jax_leaves(params)
    load_params(port, params_from_jax(jax.device_get(params)))
    return jmodel, params, port


def _frames(cfg, B, S, seed=0):
    return (np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)) * 0.1).astype(np.float32)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)


def test_full_whisper_has_the_jax_leaf_names_and_shapes():
    jmodel = jax_build(jax_config(ARCH))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    port = build_model(get_config(ARCH), device="meta")
    assert _leaves(port) == _jax_leaves(shapes)
    n = sum(t.numel() for t in port.parameters())
    assert n == 793_560_064  # with the 32,768-row dec_pos: 1.59 GB in bf16


@pytest.mark.parametrize("S", [64, 1024])
def test_encode_matches_the_jax_model(S):
    """64 frames (the reduced enc_seq) and 1,024 (two of the reference's
    512-row chunks; the learned positions tiled)."""
    jmodel, params, port = _pair()
    frames = _frames(port.cfg, 2, S)
    want = jax.jit(jmodel.encode)(params, jnp.asarray(frames))
    got = port.encode(torch.from_numpy(frames))
    assert got.shape == (2, S, port.cfg.d_model) and got.dtype == torch.float32
    _close(got, want)


def test_reference_encoder_fails_past_a_chunk():
    """The reference's fault (ROADMAP.md §3): 600 frames are one full chunk
    of 512 and a dropped remainder of 88, which its reshape refuses."""
    jmodel, params, _ = _pair()
    with pytest.raises(TypeError, match="reshape"):
        jmodel.encode(params, jnp.asarray(_frames(jmodel.cfg, 1, 600)))


def test_encode_matches_full_attention_at_600_frames(monkeypatch):
    """The reference with ``_attn`` patched to one chunk of all Sq rows
    (its own code, the exact full attention) against the port at 600."""
    ref_attn = jwhisper._attn

    def one_chunk(p, xq, xkv, cfg, *, causal, chunk=512):
        return ref_attn(p, xq, xkv, cfg, causal=causal, chunk=xq.shape[1])

    monkeypatch.setattr(jwhisper, "_attn", one_chunk)
    jmodel, params, port = _pair()
    frames = _frames(port.cfg, 2, 600)
    _close(port.encode(torch.from_numpy(frames)), jmodel.encode(params, jnp.asarray(frames)))


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", BF16_TOL)])
def test_prefill_cache_and_decode_match_the_jax_model(dtype, tol):
    """Prefill over a prompt padded past its length, the whole cache, then
    rewind ``pos`` and decode the 8 held-back tokens over the padding; in
    f32, and in bf16 (whisper-medium's dtype) within the bf16 tolerance."""
    jmodel, params, port = _pair(param_dtype=dtype, compute_dtype=dtype)
    cfg = port.cfg
    B, S, extra = 2, 20, 8
    frames = _frames(cfg, B, cfg.enc_seq)
    tokens = _tokens(cfg, B, S + extra)
    padded = tokens.copy()
    padded[:, S:] = 0

    jlogits, jcache = jax.jit(jmodel.prefill)(
        params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(padded)})
    tlogits, tcache = port.prefill(torch.from_numpy(frames), torch.from_numpy(padded))
    _close(tlogits, jlogits, tol=tol)
    assert set(tcache) == set(jcache)
    for key in ("k", "v", "ck", "cv"):
        assert tuple(tcache[key].shape) == tuple(jcache[key].shape), key
        assert tcache[key].dtype == port.cfg.cdtype, key
        _close(tcache[key], jcache[key], err_msg=key, tol=tol)
    assert int(tcache["pos"]) == int(jcache["pos"]) == S + extra

    jcache["pos"] = jnp.asarray(S, jnp.int32)
    tcache["pos"] = torch.tensor(S, dtype=torch.int32)
    step = jax.jit(jmodel.decode_step)
    for t in range(S, S + extra):
        jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = port.decode_step(tcache, torch.from_numpy(tokens[:, t:t + 1]))
        _close(tl, jl, err_msg=f"step {t}", tol=tol)
    assert int(tcache["pos"]) == S + extra
    _close(tcache["k"], jcache["k"], tol=tol)


def _jax_greedy(jmodel, params, frames, prompts, capacity, max_new):
    """The JAX engine's algorithm for attention families
    (``src/repro/serving/engine.py:106-112``) on the model's own entry
    points, with the frames its engine does not pass."""
    B, S = prompts.shape
    padded = np.zeros((B, capacity), np.int32)
    padded[:, :S - 1] = prompts[:, :S - 1]
    _, cache = jax.jit(jmodel.prefill)(
        params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(padded)})
    cache["pos"] = jnp.asarray(S - 1, jnp.int32)
    step = jax.jit(jmodel.decode_step)
    logits, cache = step(params, cache, jnp.asarray(prompts[:, S - 1:]))
    out = []
    for i in range(max_new):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok))
        if i + 1 < max_new:
            logits, cache = step(params, cache, tok)
    return np.concatenate(out, axis=1)


def _port_greedy(port, frames, prompts, capacity, max_new):
    """The same loop on the port's model: tokens stay on the device."""
    B, S = prompts.shape
    padded = np.zeros((B, capacity), np.int64)
    padded[:, :S - 1] = prompts[:, :S - 1]
    _, cache = port.prefill(torch.from_numpy(frames), torch.from_numpy(padded))
    cache["pos"] = torch.full((), S - 1, dtype=torch.int32, device=port.device)
    logits, cache = port.decode_step(cache, torch.from_numpy(prompts[:, S - 1:]).long())
    out = []
    for i in range(max_new):
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        out.append(tok)
        if i + 1 < max_new:
            logits, cache = port.decode_step(cache, tok)
    return torch.cat(out, dim=1).numpy().astype(np.int32)


def test_greedy_serving_loop_matches_the_jax_model():
    jmodel, params, port = _pair(seed=2)
    cfg = port.cfg
    frames = _frames(cfg, 2, cfg.enc_seq, seed=3)
    prompts = _tokens(cfg, 2, 16, seed=4)
    want = _jax_greedy(jmodel, params, frames, prompts, capacity=32, max_new=12)
    got = _port_greedy(port, frames, prompts, capacity=32, max_new=12)
    np.testing.assert_array_equal(got, want)


def test_prefill_consistent_with_decode_replay():
    """Mirrors ``tests/test_models.py:63-78`` on the port alone: the
    prompt's prefill logits equal a replay through ``decode_step`` into an
    empty cache (the port runs at the config's enc_seq)."""
    port = build_model(get_config(ARCH).reduced(), device="cpu", seed=1)
    B, S = 2, 12
    frames = torch.from_numpy(_frames(port.cfg, B, port.cfg.enc_seq))
    tokens = torch.from_numpy(_tokens(port.cfg, B, S))
    logits_pf, full = port.prefill(frames, tokens)
    cache = {**port.empty_cache(B, S + 4), "ck": full["ck"], "cv": full["cv"]}
    for t in range(S):
        logits_dec, cache = port.decode_step(cache, tokens[:, t:t + 1])
    np.testing.assert_allclose(_np(logits_pf), _np(logits_dec), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways_bit_equal(tmp_path, dtype):
    """A JAX-saved whisper checkpoint restores through the port's readers
    onto a meta-device model, and a port-saved one through the JAX package,
    bit for bit (bf16 leaves by their 16-bit patterns)."""
    jmodel, params, port = _pair(param_dtype=dtype, compute_dtype=dtype)
    jpath = jck.save_checkpoint(str(tmp_path / "jax"), 1, params)
    meta = build_model(port.cfg, device="meta")
    for got in (load_checkpoint(jpath, meta.param_tree())[0],
                restore_pipelined(jpath, meta.param_tree(), device="cpu")[0]):
        for name, t in flatten(got, "param").items():
            assert torch.equal(t, flatten(port.param_tree(), "param")[name]), name
    tpath = save_checkpoint(str(tmp_path / "port"), 2, port.param_tree())
    back, _, _ = jck.load_checkpoint(tpath, params)
    want = flatten(jax.device_get(params), "param")
    for name, a in flatten(jax.device_get(back), "param").items():
        assert a.dtype == want[name].dtype, name
        width = np.int16 if dtype == "bfloat16" else np.int32
        np.testing.assert_array_equal(np.asarray(a).view(width),
                                      np.asarray(want[name]).view(width), err_msg=name)


def test_restored_model_serves_the_same_logits(tmp_path):
    """A port checkpoint restored onto a meta-device model by the cold start
    gives the source model's prefill logits exactly."""
    src = build_model(get_config(ARCH).reduced(), device="cpu", seed=5)
    path = save_checkpoint(str(tmp_path), 1, src.param_tree())
    model = build_model(src.cfg, device="meta")
    load_params(model, restore_pipelined(path, model.param_tree(), device="cpu")[0])
    frames = torch.from_numpy(_frames(src.cfg, 2, src.cfg.enc_seq))
    tokens = torch.from_numpy(_tokens(src.cfg, 2, 8))
    assert torch.equal(model.prefill(frames, tokens)[0], src.prefill(frames, tokens)[0])


def test_train_loss_raises_naming_its_item():
    port = build_model(get_config(ARCH).reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 10.*K9"):
        port.train_loss({"frames": None, "tokens": None})


def test_reference_engine_cannot_serve_encdec():
    """The reference's fault (ROADMAP.md §3): its engine's prefill passes
    only tokens, and the model's prefill needs frames."""
    jmodel, params, _ = _pair()
    prompts = _tokens(jmodel.cfg, 2, 8)
    with pytest.raises(KeyError, match="frames"):
        JaxEngine(jmodel, params).generate(prompts, max_new=2)


def test_port_engine_refuses_encdec_and_names_the_entry_points():
    port = build_model(get_config(ARCH).reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="prefill.*decode_step"):
        ServeEngine(port)
    with pytest.raises(NotImplementedError, match="encdec"):
        serve_main(["--arch", ARCH, "--device", "cpu", "--random"])
