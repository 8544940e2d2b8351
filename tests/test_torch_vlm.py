"""The port's vlm family (llava-next-mistral-7b: the Mistral backbone behind
a stubbed vision front end) against the JAX package.

For the reduced ``llava_next_mistral_7b`` config in f32 (2 layers, 4 heads
over 2 KV heads of 32, 16 patches, a window of 64 on every layer) the JAX
params are carried into the port (``convert.params_from_jax``). The patch
embeddings (B, P, d) are projected by ``mm_proj`` and prepended, so a
prefill runs over P + S positions, past the window. Held to the JAX
package: the prefill with patches (logits and cache within ``1e-4`` of
each tensor's scale, ``tests/test_torch_serving.py``'s ``TOL``) and decode
steps after it; the engine's greedy tokens on a JAX-saved checkpoint
(text-only, as the JAX engine serves this family); ``train_loss`` with
patches and every gradient against ``jax.value_and_grad`` (``LOSS_TOL``
1e-5, ``GRAD_TOL`` 1e-3 of each leaf's largest entry, as
``tests/test_torch_train.py``); checkpoints both ways, bit for bit. The
prefix-masking check mirrors ``tests/test_models.py::test_vlm_prefix_masking``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.checkpoint as jck
from repro.checkpoint.store import _leaf_name
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serving import ServeEngine as JaxEngine
from repro_torch.checkpoint import load_checkpoint, restore_pipelined, save_checkpoint
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving import ServeEngine

TOL = 1e-4  # of each tensor's scale: rtol 1e-4, atol 1e-4 * max(1, max |want|)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3  # of each leaf's largest |gradient|
ARCH = "llava_next_mistral_7b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, err_msg=""):
    got, want = _np(got), _np(want)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=atol, err_msg=err_msg)


def _leaves(model):
    return {name: (tuple(t.shape), str(t.dtype).rsplit(".", 1)[-1])
            for name, t in flatten(model.param_tree(), "param").items()}


def _jax_leaves(tree):
    return {_leaf_name(path, "param"): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(seed=0, **changes):
    jcfg = jax_config(ARCH).reduced().with_(**changes)
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    port = build_model(get_config(ARCH).reduced().with_(**changes), device="cpu")
    assert isinstance(port, TransformerLM)
    assert _leaves(port) == _jax_leaves(params)
    load_params(port, params_from_jax(jax.device_get(params)))
    return jmodel, params, port


def _patches(cfg, B, seed=0):
    """The stub vision front end's output, as ``tests/test_models.py:_batch``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, cfg.n_patches, cfg.d_model)) * 0.1).astype(np.float32)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)


def test_full_llava_has_the_jax_leaf_names_and_shapes():
    jmodel = jax_build(jax_config(ARCH))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    port = build_model(get_config(ARCH), device="meta")
    assert _leaves(port) == _jax_leaves(shapes)
    assert tuple(port.mm_proj.shape) == (4096, 4096)
    n = sum(t.numel() for t in port.parameters())
    assert n == 7_258_509_312  # 14.5 GB in bf16


def test_prefill_with_patches_and_decode_match_the_jax_model():
    """Patches + tokens = 16 + 60 positions, past the window of 64; then
    rewind ``pos`` into the padding and decode 3 held-back tokens."""
    jmodel, params, port = _pair()
    cfg = port.cfg
    B, S, extra = 2, 60, 3
    P = cfg.n_patches
    patches = _patches(cfg, B)
    tokens = _tokens(cfg, B, S + extra)
    padded = tokens.copy()
    padded[:, S:] = 0
    batch = {"tokens": jnp.asarray(padded), "patch_embeds": jnp.asarray(patches)}
    jlogits, jcache = jax.jit(jmodel.prefill)(params, batch)
    tlogits, tcache = port.prefill(torch.from_numpy(padded), torch.from_numpy(patches))
    _close(tlogits, jlogits)
    for kv in ("k", "v"):
        assert tcache["dense"][kv].shape[3] == P + S + extra
        _close(tcache["dense"][kv], jcache["dense"][kv], err_msg=kv)
    assert int(tcache["pos"]) == int(jcache["pos"]) == P + S + extra

    jcache["pos"] = jnp.asarray(P + S, jnp.int32)
    tcache["pos"] = torch.tensor(P + S, dtype=torch.int32)
    step = jax.jit(jmodel.decode_step)
    for t in range(S, S + extra):
        jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = port.decode_step(tcache, torch.from_numpy(tokens[:, t:t + 1]))
        _close(tl, jl, err_msg=f"step {t}")


def test_engine_serves_text_only_as_the_jax_engine(tmp_path):
    """The JAX engine passes no patches (``src/repro/serving/engine.py:106-112``):
    on a JAX-saved vlm checkpoint both engines give the same greedy tokens
    for text prompts, the window crossed (a prompt of 72 + 8 new)."""
    jmodel, params, _ = _pair(seed=3)
    path = jck.save_checkpoint(str(tmp_path), 1, params)
    prompts = _tokens(jmodel.cfg, 2, 72, seed=4)
    want = JaxEngine(jmodel, checkpoint=path).generate(prompts, max_new=8)
    engine = ServeEngine(build_model(get_config(ARCH).reduced(), device="meta"),
                         checkpoint=path, device="cpu")
    np.testing.assert_array_equal(engine.generate(prompts, max_new=8), want)


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_and_grads_with_patches_match_jax(remat):
    """The loss over the text positions (16 patches + 48 tokens) and every
    gradient, ``mm_proj``'s included."""
    jmodel, params, port = _pair(remat=remat)
    port.requires_grad_(True)
    cfg = port.cfg
    toks = _tokens(cfg, 2, 48).astype(np.uint32)
    patches = _patches(cfg, 2)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_loss(p, {"tokens": jnp.asarray(toks.astype(np.int32)),
                                        "patch_embeds": jnp.asarray(patches)}),
        has_aux=True))(params)
    loss, met = port.train_loss({"tokens": torch.from_numpy(toks),
                                 "patch_embeds": torch.from_numpy(patches)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_TOL)
    for key in ("ce", "aux", "acc", "loss"):
        np.testing.assert_allclose(float(met[key].detach()), float(jmet[key]), rtol=LOSS_TOL,
                                   atol=1e-7)
    want = {name: np.asarray(g) for name, g in flatten(jax.device_get(jg), "param").items()}
    got = {name: p.grad for name, p in flatten(port.param_tree(), "param").items()}
    assert set(got) == set(want) and "param__mm_proj" in got
    for name, g in want.items():
        assert got[name] is not None, name
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(_np(got[name]), g, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg=name)


def test_vlm_prefix_masking():
    """Mirrors ``tests/test_models.py::test_vlm_prefix_masking`` on the port:
    the loss covers text positions only, and the patches feed into it."""
    port = build_model(get_config(ARCH).reduced(), device="cpu", seed=0)
    cfg = port.cfg
    toks = torch.from_numpy(_tokens(cfg, 2, 32, seed=0))
    patches = torch.from_numpy(_patches(cfg, 2))
    with torch.no_grad():
        loss1, met = port.train_loss({"tokens": toks, "patch_embeds": patches})
        loss2, _ = port.train_loss({"tokens": toks, "patch_embeds": patches * 2.0})
        text_only, _ = port.train_loss({"tokens": toks})
    assert not np.isclose(float(loss1), float(loss2))
    assert not np.isclose(float(loss1), float(text_only))
    assert 0.0 <= float(met["acc"]) <= 1.0


def test_patches_are_ignored_without_a_vlm_config():
    """A dense model given patch embeddings ignores them, as the reference's
    ``_embed_inputs`` does (``if cfg.n_patches and "patch_embeds" in batch``):
    the port's prefill and loss match the JAX model's on the same batch, and
    its own on the tokens alone."""
    jcfg = jax_config("paper_lm").reduced()
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    port = build_model(get_config("paper_lm").reduced(), device="cpu")
    load_params(port, params_from_jax(jax.device_get(params)))
    tokens = _tokens(jcfg, 2, 12)
    patches = (np.random.default_rng(2).normal(size=(2, 3, jcfg.d_model)) * 0.1).astype(np.float32)
    batch = {"tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(patches)}
    jlogits, _ = jax.jit(jmodel.prefill)(params, batch)
    tlogits, tcache = port.prefill(torch.from_numpy(tokens), torch.from_numpy(patches))
    assert int(tcache["pos"]) == tokens.shape[1]
    _close(tlogits, jlogits)
    _close(tlogits, port.prefill(torch.from_numpy(tokens))[0])
    jloss, _ = jmodel.train_loss(params, batch)
    with torch.no_grad():
        tloss, _ = port.train_loss({"tokens": torch.from_numpy(tokens),
                                    "patch_embeds": torch.from_numpy(patches)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways_bit_equal(tmp_path, dtype):
    """A JAX-saved vlm checkpoint restores through the port's readers onto a
    meta-device model, and a port-saved one through the JAX package, bit
    for bit (bf16 leaves by their 16-bit patterns)."""
    jmodel, params, port = _pair(param_dtype=dtype, compute_dtype=dtype)
    jpath = jck.save_checkpoint(str(tmp_path / "jax"), 1, params)
    meta = build_model(port.cfg, device="meta")
    have = flatten(port.param_tree(), "param")
    for got in (load_checkpoint(jpath, meta.param_tree())[0],
                restore_pipelined(jpath, meta.param_tree(), device="cpu")[0]):
        got = flatten(got, "param")
        assert set(got) == set(have) and "param__mm_proj" in got
        for name, t in got.items():
            assert torch.equal(t, have[name]), name
    tpath = save_checkpoint(str(tmp_path / "port"), 2, port.param_tree())
    back, _, _ = jck.load_checkpoint(tpath, params)
    want = flatten(jax.device_get(params), "param")
    width = np.int16 if dtype == "bfloat16" else np.int32
    for name, a in flatten(jax.device_get(back), "param").items():
        assert a.dtype == want[name].dtype, name
        np.testing.assert_array_equal(np.asarray(a).view(width),
                                      np.asarray(want[name]).view(width), err_msg=name)
