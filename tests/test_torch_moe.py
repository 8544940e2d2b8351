"""The port's moe family (DeepSeek-V3 on MLA, Kimi-K2 on GQA) against the
JAX package.

Reduced configs in f32 (``ModelConfig.reduced()``: 4 experts, top-2, a
shared expert; DeepSeek-V3's MLA at q_lora 64, kv_lora 32, rope 16, with 3
layers here so that its moe stack holds 2 after the dense prefix of 1). The
JAX params, their attention tempered (``_temper``), are carried into the
port (``convert.params_from_jax``), inputs come from numpy seeds, and every
tensor is held within ``TOL`` of its
scale, as ``tests/test_torch_serving.py``. Held to the JAX package: the
router (expert ids exactly), ``moe_ffn``'s output and aux loss over one and
two dispatch chunks and at a capacity low enough that routes drop; MLA's
expanded prefill and its cache, and its absorbed decode at several
positions; the models' prefill and decode logits and caches; the engines'
greedy tokens; the full configs' leaf names and shapes; checkpoints both
ways, bit for bit. The plain attention versions are held to the JAX
oracles at MLA's widths, (192, 128) for the prefill and (576, 512) over
shared rows for the decode.
"""

import contextlib
import dataclasses
import math
import os
import shutil
import zlib
from unittest import mock

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
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import common as jax_common
from repro.models import moe as jmoe
from repro.models.common import Initializer as JaxInitializer
from repro.serving import ServeEngine as JaxEngine
from repro.train import TrainLoopConfig as JaxLoopConfig
from repro.train import train as jax_train
from repro_torch.checkpoint import load_checkpoint, restore_pipelined, save_checkpoint
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import get_config
from repro_torch.data import DataLoader, RaDataset, make_token_dataset
from repro_torch.distributed import optimizer as topt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.common import rope_freqs
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving import ServeEngine
from repro_torch.train import TrainLoopConfig
from repro_torch.train import train as port_train

TOL = 1e-4  # of each tensor's scale: rtol 1e-4, atol 1e-4 * max(1, max |want|)
ATTN_TOL = 2e-5  # f32, tests/test_kernels.py:19
MOE = ["deepseek_v3_671b", "kimi_k2_1t"]
# the reduced configs as tested: deepseek-v3 with 3 layers (1 dense + 2 moe)
CHANGES = {"deepseek_v3_671b": {"n_layers": 3}, "kimi_k2_1t": {}}


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


def _configs(arch, **changes):
    changes = {**CHANGES[arch], **changes}
    return jax_config(arch).reduced().with_(**changes), get_config(arch).reduced().with_(**changes)


def _temper(params, cfg):
    """The JAX params with every served layer's attention projections scaled
    to their contraction width, as ``chip_smoke.py:_temper_attention`` scales
    the card's models (``tests/test_torch_zamba.py:_temper``). ``fanin``
    divides by ``shape[-2]``: the head count for GQA's ``wq``/``wk``/``wv``
    and MLA's ``wq_b``/``wkv_b`` (whose contraction is the rank), the head
    width for ``wo`` (whose contraction is all heads). At those scales the
    reduced Kimi-K2's scores have a std near 40, its softmax is all but an
    argmax, and one f32 rounding can move a logit past ``TOL`` in either
    package (the init differs by process: it folds in a salted hash)."""
    H = cfg.n_heads
    if cfg.attn_type == "mla":
        m = cfg.mla
        factors = {"wq_b": H / m.q_lora_rank, "wkv_b": H / m.kv_lora_rank, "wo": 1 / H}
    else:
        KV, d = cfg.n_kv_heads, cfg.d_model
        factors = {"wq": H / d, "wk": KV / d, "wv": KV / d, "wo": 1 / H}
    out = dict(params)
    for stack in ("dense_layers", "moe_layers"):
        attn = {k: v * factors[k] ** 0.5 if k in factors else v
                for k, v in params[stack]["attn"].items()}
        out[stack] = {**params[stack], "attn": attn}
    return out


def _pair(arch, seed=0, **changes):
    jcfg, tcfg = _configs(arch, **changes)
    jmodel = jax_build(jcfg)
    params = _temper(jax.jit(jmodel.init)(jax.random.PRNGKey(seed)), jcfg)
    port = build_model(tcfg, device="cpu")
    assert isinstance(port, TransformerLM)
    assert _leaves(port) == _jax_leaves(params)
    load_params(port, params_from_jax(jax.device_get(params)))
    return jmodel, params, port


def _module_params(init, cfg, seed):
    """A JAX module's params from its own init, and the port's copy."""
    p = init(JaxInitializer(jax.random.PRNGKey(seed), jnp.float32), cfg)
    return p, params_from_jax(jax.device_get(p))


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("router", ["sigmoid", "softmax"])
def test_route_and_moe_ffn_match_jax(chunks, capacity_factor, router):
    jcfg, tcfg = _configs("deepseek_v3_671b")
    m = dataclasses.replace(jcfg.moe, dispatch_chunks=chunks, capacity_factor=capacity_factor,
                            router=router)
    jcfg, tcfg = jcfg.with_(moe=m), tcfg.with_(moe=m)
    jp, tp = _module_params(jmoe.init_moe, jcfg, seed=11)
    B, S = 2, 24
    x = _x(jcfg, B, S, seed=12)
    jidx, jgates, jaux = jmoe.route(jp, jnp.asarray(x.reshape(B * S, -1)), jcfg)
    tidx, tgates, taux = tmoe.route(tp, torch.from_numpy(x.reshape(B * S, -1)), tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tgates, jgates)
    _close(taux, jaux)

    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(taux, jaux)
    # at the low capacity some expert's queue overflows in some chunk: routes drop
    T = B * S // chunks
    C = max(1, math.ceil(T * m.top_k / m.n_experts * capacity_factor))
    counts = [np.bincount(c.ravel(), minlength=m.n_experts)
              for c in np.asarray(jidx).reshape(chunks, T, m.top_k)]
    if capacity_factor < 1.0:
        assert max(c.max() for c in counts) > C


def test_mla_prefill_and_decode_match_jax():
    jcfg, tcfg = _configs("deepseek_v3_671b")
    ml = jcfg.mla
    jp, tp = _module_params(jattn.init_mla, jcfg, seed=21)
    B, S, cap = 2, 40, 48
    x = _x(jcfg, B, cap, seed=22)
    freqs = rope_freqs(ml.qk_rope_head_dim, jcfg.rope_theta)
    jout, jcache = jattn.mla_attention(jp, jnp.asarray(x[:, :S]), jcfg,
                                       positions=jnp.arange(S), with_cache=True, chunk=16)
    tout, latent, k_rope = tattn.mla_prefill(tp, torch.from_numpy(x[:, :S]), tcfg,
                                             positions=torch.arange(S), freqs=freqs)
    _close(tout, jout)
    _close(latent, jcache["latent"])
    _close(k_rope, jcache["k_rope"])

    # decode the positions S.. from a cache of capacity ``cap``
    r, rope = ml.kv_lora_rank, ml.qk_rope_head_dim
    jc = {"latent": jnp.zeros((B, cap, r)).at[:, :S].set(jcache["latent"]),
          "k_rope": jnp.zeros((B, cap, rope)).at[:, :S].set(jcache["k_rope"])}
    rows = torch.zeros(B, cap, r + rope)
    rows[:, :S] = torch.cat([latent, k_rope], -1)
    for pos in (S, S + 1, cap - 1):
        jo, jc = jattn.mla_decode(jp, jnp.asarray(x[:, pos:pos + 1]), jc, jnp.int32(pos), jcfg)
        to = tattn.mla_decode(tp, torch.from_numpy(x[:, pos:pos + 1]), rows,
                              torch.tensor(pos, dtype=torch.int32), tcfg, freqs=freqs)
        _close(to, jo, err_msg=f"pos {pos}")
        _close(rows[..., :r], jc["latent"], err_msg=f"pos {pos}")
        _close(rows[..., r:], jc["k_rope"], err_msg=f"pos {pos}")


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_the_jax_model(arch):
    jmodel, params, port = _pair(arch)
    cfg = port.cfg
    assert (port.n_dense, port.n_moe) == (1, cfg.n_layers - 1)
    B, S, extra = 2, 80, 3
    tokens = np.random.default_rng(7).integers(1, cfg.vocab, (B, S + extra)).astype(np.int32)
    padded = tokens.copy()
    padded[:, S:] = 0

    jlogits, jcache = jax.jit(jmodel.prefill)(params, {"tokens": jnp.asarray(padded)})
    tlogits, tcache = port.prefill(torch.from_numpy(padded).long())
    _close(tlogits, jlogits)
    names = ("latent", "k_rope") if cfg.attn_type == "mla" else ("k", "v")
    for group in ("dense", "moe"):
        for name in names:
            _close(tcache[group][name], jcache[group][name], err_msg=f"{group}.{name}")
    assert int(tcache["pos"]) == int(jcache["pos"]) == S + extra

    jcache["pos"] = jnp.asarray(S, jnp.int32)
    tcache["pos"] = torch.tensor(S, dtype=torch.int32)
    step = jax.jit(jmodel.decode_step)
    for t in range(S, S + extra):
        jl, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = port.decode_step(tcache, torch.from_numpy(tokens[:, t:t + 1]).long())
        _close(tl, jl, err_msg=f"step {t}")
    for group in ("dense", "moe"):
        for name in names:
            _close(tcache[group][name], jcache[group][name], err_msg=f"{group}.{name}")


@pytest.mark.parametrize("arch", MOE)
def test_engine_matches_the_jax_engine(tmp_path, arch):
    """The engines pad the prompts with token 0 to the capacity; those rows
    compete for expert capacity after the real ones, alike in both."""
    jmodel, params, _ = _pair(arch, seed=3)
    path = jck.save_checkpoint(str(tmp_path), 1, params)
    prompts = np.random.default_rng(4).integers(1, jmodel.cfg.vocab, (2, 20)).astype(np.int32)
    want = JaxEngine(jmodel, checkpoint=path).generate(prompts, max_new=8)
    engine = ServeEngine(build_model(_configs(arch)[1], device="meta"), checkpoint=path,
                         device="cpu")
    np.testing.assert_array_equal(engine.generate(prompts, max_new=8), want)


@pytest.mark.parametrize("arch,params", [
    ("deepseek_v3_671b", 671_712_655_360),   # 61 layers and the MTP head
    ("kimi_k2_1t", 1_027_291_575_296),
])
def test_full_configs_have_the_jax_leaf_names_and_shapes(arch, params):
    jmodel = jax_build(jax_config(arch))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    port = build_model(get_config(arch), device="meta")
    leaves = _leaves(port)
    assert leaves == _jax_leaves(shapes)
    assert any(name.startswith("param__mtp__") for name in leaves) == (arch == "deepseek_v3_671b")
    assert sum(t.numel() for t in port.parameters()) == params


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways_bit_equal(tmp_path, arch, dtype):
    """A JAX-saved moe checkpoint restores through the port's readers onto a
    meta-device model, and a port-saved one through the JAX package, bit
    for bit (bf16 leaves by their 16-bit patterns)."""
    jmodel, params, port = _pair(arch, param_dtype=dtype, compute_dtype=dtype)
    jpath = jck.save_checkpoint(str(tmp_path / "jax"), 1, params)
    meta = build_model(port.cfg, device="meta")
    have = flatten(port.param_tree(), "param")
    for got in (load_checkpoint(jpath, meta.param_tree())[0],
                restore_pipelined(jpath, meta.param_tree(), device="cpu")[0]):
        got = flatten(got, "param")
        assert set(got) == set(have) and "param__moe_layers__ffn__w_gate" in got
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


# ------------------------------------------------------------------ training
LOSS_TOL = 1e-5  # tests/test_torch_train.py's tolerances and their reasons
GRAD_TOL = 1e-3
RUN_TOL = 1e-4
FLIP_SHARE = 1e-4


@contextlib.contextmanager
def _recorded_routes(out: list):
    """Each routing call's expert ids in the port, in call order."""
    kept = tmoe.route

    def route(p, x2d, cfg, *split):
        idx, gates, aux = kept(p, x2d, cfg, *split)
        out.append((idx.detach().clone(), x2d.shape[0], cfg))
        return idx, gates, aux

    tmoe.route = route
    try:
        yield
    finally:
        tmoe.route = kept


def _dropped(records) -> int:
    """Routes past their expert's capacity, over the recorded calls."""
    n = 0
    for idx, T, cfg in records:
        m = cfg.moe
        C = max(1, math.ceil(T * m.top_k / m.n_experts * m.capacity_factor))
        n += int(np.maximum(np.bincount(idx.numpy().ravel(), minlength=m.n_experts) - C, 0).sum())
    return n


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("remat,chunks,capacity_factor", [
    (False, 1, 1.25),
    (True, 1, 1.25),    # each layer under torch.utils.checkpoint
    (False, 2, 0.5),    # two dispatch chunks, routes dropped
    (True, 2, 0.5),
])
def test_train_loss_and_grads_match_jax(arch, remat, chunks, capacity_factor):
    """``train_loss`` of the reduced moe models (DeepSeek-V3 with MLA and
    MTP, Kimi-K2 on GQA) and every gradient leaf against
    ``jax.value_and_grad`` of the reference's, at tests/test_torch_train.py's
    tolerances: every metric (``mtp`` too), with and without remat, over one
    and two dispatch chunks, and at a capacity factor at which routes drop
    (the gradient then flows through the dropped routes' gates, by their
    renormalization, and not through their slot)."""
    jcfg, _ = _configs(arch)
    m = dataclasses.replace(jcfg.moe, dispatch_chunks=chunks, capacity_factor=capacity_factor)
    jmodel, params, port = _pair(arch, remat=remat, moe=m)
    port.requires_grad_(True)
    cfg = port.cfg
    toks = np.random.default_rng(chunks).integers(0, cfg.vocab, (2, 48)).astype(np.int32)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_loss(p, {"tokens": jnp.asarray(toks)}), has_aux=True))(params)
    records = []
    with _recorded_routes(records):
        loss, met = port.train_loss({"tokens": torch.from_numpy(toks)})
    loss.backward()
    assert set(met) == set(jmet) == {"ce", "aux", "acc", "loss"} | ({"mtp"} if cfg.mtp else set())
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=LOSS_TOL)
    for key in jmet:
        np.testing.assert_allclose(float(met[key].detach()), float(jmet[key]), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=key)
    assert float(met["aux"].detach()) > 0
    if capacity_factor < 1.0:
        assert _dropped(records) > 0
    want = {name: np.asarray(g) for name, g in flatten(jax.device_get(jg), "param").items()}
    got = {name: p.grad for name, p in flatten(port.param_tree(), "param").items()}
    assert set(got) == set(want)
    for name, g in want.items():
        assert got[name] is not None and np.abs(g).max() > 0, name
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(_np(got[name]), g, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg=name)


def test_moe_backward_is_bit_equal_twice():
    """Two backward passes of a MoE layer give bit-equal gradients: the
    dispatch's index ops are gathers whose gradients are gathers, summed in
    a fixed order (on the card too: tests/test_torch_cuda.py)."""
    jcfg, tcfg = _configs("kimi_k2_1t")
    m = dataclasses.replace(tcfg.moe, dispatch_chunks=2, capacity_factor=0.5)
    tcfg = tcfg.with_(moe=m)
    _, tp = _module_params(jmoe.init_moe, jcfg, seed=41)
    x = torch.from_numpy(_x(tcfg, 2, 24, seed=42))
    grads = []
    for _ in range(2):
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        xg = x.clone().requires_grad_()
        y, aux = tmoe.moe_ffn(leaves, xg, tcfg)
        (y.square().sum() + aux).backward()
        grads.append([xg.grad] + [leaves[k].grad for k in sorted(leaves)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_one_adamw_step_with_int8_moments_matches_jax():
    """One step of each package from the same reduced DeepSeek-V3 (MLA, MTP,
    both stacks) and batch, AdamW with the config's int8 blockwise moments
    (``opt_moment_dtype``, as the reference's distributed step sets it). A
    first step moves each entry by about lr·sign(g), so entries whose
    gradient is within the gradient tolerance of zero may be up to 2·lr
    apart; of the rest, at most ``FLIP_SHARE`` may differ past ``RUN_TOL``
    (a moment whose value sits at a rounding edge of its code takes the
    other code). The int8 codes are at most one apart."""
    jmodel, params, port = _pair("deepseek_v3_671b")
    port.requires_grad_(True)
    cfg = port.cfg
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 48)).astype(np.int32)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10, moment_dtype="int8")
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    batch = {"tokens": jnp.asarray(toks)}
    grads = jax.jit(jax.grad(lambda p: jmodel.train_loss(p, batch)[0]))(params)
    jp, js, _ = jax.jit(lambda p, g: jopt.apply_updates(p, g, jopt.init_state(p, jcfg),
                                                        jcfg))(params, grads)

    from repro_torch.train.loop import make_step

    tparams = port.param_tree()
    state = topt.init_state(tparams, tcfg)
    make_step(port, tcfg)(tparams, state, {"tokens": torch.from_numpy(toks)})
    want = {n: np.asarray(x) for n, x in flatten(jax.device_get(jp), "param").items()}
    grad = {n: np.abs(np.asarray(x)) for n, x in flatten(jax.device_get(grads), "param").items()}
    off_total = size = 0
    for name, p in flatten(port.param_tree(), "param").items():
        got = _np(p)
        np.testing.assert_allclose(got, want[name], rtol=0, atol=2.2 * kw["lr"], err_msg=name)
        off = ~np.isclose(got, want[name], rtol=RUN_TOL, atol=1e-6)
        off_total += int((off & (grad[name] > GRAD_TOL * grad[name].max())).sum())
        size += got.size
    assert off_total <= FLIP_SHARE * size, f"{off_total} of {size}"
    jstate = flatten(jax.device_get(js), "opt")
    tstate = flatten(state, "opt")
    assert set(tstate) == set(jstate) and any(t.dtype == torch.int8 for t in tstate.values())
    for name, t in tstate.items():
        if t.dtype == torch.int8:
            assert np.abs(t.numpy().astype(np.int32) - jstate[name].astype(np.int32)).max() <= 1
    assert int(state["step"]) == 1


def _moe_loop(pkg_cfg, adamw_cls, ckpt_dir, steps):
    return pkg_cfg(steps=steps, ckpt_every=3, ckpt_dir=ckpt_dir, log_every=1000,
                   adamw=adamw_cls(lr=1e-4, warmup_steps=2, total_steps=50, moment_dtype="int8"))


def _path_hash(path):
    """A string hash that is the same in every process (crc32)."""
    return zlib.crc32(path.encode())


def _same_in_every_process():
    """The reference's init folds ``hash(path)`` into its key, which Python
    salts per process (ROADMAP.md §3 fault 5); inside this it folds
    ``_path_hash``, as ``tests/test_torch_train.py:_pair`` does, so the
    resume tests draw the same weights in every process.

    Why a fixed draw: on some draws the two packages part at the first
    resumed update through the reference's int8 moments (ROADMAP.md §3
    fault 10, mirrored by the port). An entry whose ``v`` code is 0 while
    its ``m`` code is not moves by ~lr·m/(sqrt(v) + eps) with sqrt(v) near
    eps, and there each package's rounding of a near-zero gradient changes
    the move by up to ~3e-3 of its leaf's largest entry (PYTHONHASHSEED=23:
    every parameter that parts past 1e-6 of its leaf's largest entry after
    that update is such an entry). The next losses then part past
    ``_losses_close``'s bound in both directions."""
    return mock.patch.object(jax_common, "hash", _path_hash, create=True)


def _jax_moe_run(dataset, ckpt_dir, steps, resume=False):
    """The reference's ``train()`` on the reduced Kimi-K2 from its own
    init (``_same_in_every_process``), tempered as ``_pair`` tempers it."""
    jcfg, _ = _configs("kimi_k2_1t")
    jmodel = jax_build(jcfg)
    init = jmodel.init

    def tempered(key):
        with _same_in_every_process():
            return _temper(init(key), jcfg)
    jmodel.init = tempered
    return jax_train(jmodel, JaxLoader(JaxDataset(dataset), 4, seed=0),
                     _moe_loop(JaxLoopConfig, jopt.AdamWConfig, ckpt_dir, steps), resume=resume)


def _port_moe_run(dataset, ckpt_dir, steps, resume=False):
    """The port's ``train()`` from the reference's init (carried over)."""
    with _same_in_every_process():
        _, params, port = _pair("kimi_k2_1t")
    return port_train(port.requires_grad_(True), DataLoader(RaDataset(dataset), 4, seed=0),
                      _moe_loop(TrainLoopConfig, topt.AdamWConfig, ckpt_dir, steps),
                      resume=resume)


@pytest.fixture(scope="module")
def moe_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("moe_train") / "ds")
    make_token_dataset(root, n_docs=48, seq_len=32, vocab=512, shard_rows=48)
    return root


def _losses_close(got, want):
    """tests/test_torch_train.py's per-step gate: the k-th step after a shared
    state within LOSS_TOL·10^k, at most 3e-2."""
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        tol = min(LOSS_TOL * 10 ** k, 3e-2)
        assert abs(g - w) <= tol * abs(w), f"step {k}: {g} vs {w} (rtol {tol})"


@pytest.fixture(scope="module")
def moe_straight(moe_dataset, tmp_path_factory):
    """One straight 6-step run of each package, shared by the two resume
    tests: {"port"/"jax": (its losses, its checkpoint directory)}, where
    ``ckpt_every=3`` left the step-3 checkpoint that the other package
    resumes from."""
    root = tmp_path_factory.mktemp("moe_straight")
    runs = {}
    for name, run in (("port", _port_moe_run), ("jax", _jax_moe_run)):
        ck = str(root / name)
        runs[name] = (run(moe_dataset, ck, 6)["losses"], ck)
    return runs


def _step3(ck, into):
    """A directory holding only ``ck``'s step-3 checkpoint, to resume from."""
    os.makedirs(into)
    shutil.copytree(os.path.join(ck, "step_00000003"), os.path.join(into, "step_00000003"))
    return into


def test_port_moe_checkpoint_resumes_in_jax(moe_dataset, moe_straight, tmp_path, capsys):
    """The port's checkpoint of a reduced Kimi-K2 at step 3 (parameters,
    int8 moments with their scales, loader position) resumes in the
    reference's ``train()``, which continues the port's own losses."""
    straight, ck = moe_straight["port"]
    out = _jax_moe_run(moe_dataset, _step3(ck, str(tmp_path / "ck")), 6, resume=True)
    assert "[train] resumed from step 3" in capsys.readouterr().out
    _losses_close(out["losses"], straight[3:])


def test_jax_moe_checkpoint_resumes_in_the_port(moe_dataset, moe_straight, tmp_path, capsys):
    """And the reverse: the reference's moe checkpoint with int8 moments
    resumes in the port and continues the reference's losses."""
    straight, ck = moe_straight["jax"]
    out = _port_moe_run(moe_dataset, _step3(ck, str(tmp_path / "ck")), 6, resume=True)
    assert "[train] resumed from step 3" in capsys.readouterr().out
    _losses_close(out["losses"], straight[3:])


@pytest.mark.parametrize("B,H,KV,Sq,Sk,causal", [
    (2, 4, 4, 70, 70, True),     # MLA's prefill: group 1, a ragged tile
    (1, 8, 8, 128, 128, True),
    (2, 4, 4, 33, 90, False),
])
def test_plain_flash_attention_at_mla_widths_matches_the_jax_oracle(B, H, KV, Sq, Sk, causal):
    rng = np.random.default_rng(31)
    q, k = (rng.standard_normal((B, n, s, 192)).astype(np.float32)
            for n, s in ((H, Sq), (KV, Sk)))
    v = rng.standard_normal((B, KV, Sk, 128)).astype(np.float32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert tuple(got.shape) == (B, H, Sq, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("B,H,S,pos", [(2, 16, 64, 0), (2, 16, 64, 30), (1, 8, 100, 99)])
def test_plain_decode_attention_over_shared_rows_matches_the_jax_oracle(B, H, S, pos):
    """MLA's absorbed decode: all heads over one cache head whose rows are 576
    wide, V their first 512 columns (a view), at scale 192^-1/2."""
    rng = np.random.default_rng(32)
    q = rng.standard_normal((B, H, 576)).astype(np.float32)
    rows = rng.standard_normal((B, 1, S, 576)).astype(np.float32)
    scale = 192 ** -0.5
    want = jref.decode_attention_ref(jnp.asarray(q)[:, None], jnp.asarray(rows),
                                     jnp.asarray(rows[..., :512]), pos, scale=scale)
    t_rows = torch.from_numpy(rows)
    got = tops.decode_attention(torch.from_numpy(q), t_rows, t_rows[..., :512], pos, scale=scale)
    assert tuple(got.shape) == (B, H, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    plain = tref.decode_attention_ref(torch.from_numpy(q)[:, None], t_rows, t_rows[..., :512],
                                      pos, scale=scale)
    assert torch.equal(plain[:, 0], got)
