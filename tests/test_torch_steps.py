"""The port's sharded steps (``distributed/steps.py``) on a one-rank gloo mesh
against the JAX package's, jitted with their shardings on a one-device
``("data", "model")`` mesh: one train step of reduced OLMo, InternLM2,
Kimi-K2 and DeepSeek-V3 (with and without ``moe_ep``) over ``tp`` and ``dp``,
1 and 2 microbatches, ``grad_dtype`` None and bfloat16; the prefill and decode
steps of a reduced dense model, of Mamba2, Zamba2, Kimi-K2 and DeepSeek-V3. The weights are the port's
init from a seed, handed to the JAX package as numpy arrays (the
reference's own init folds in a salted hash and compiles for seconds), the
attention tempered as ``tests/test_torch_moe.py`` tempers it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.checkpoint.store import _leaf_name
from repro.configs import get_config as jax_config
from repro.distributed import optimizer as jopt
from repro.distributed import steps as jsteps
from repro.launch.shapes import ShapeSpec as JShape
from repro.models import build_model as jax_build
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import get_config
from repro_torch.distributed import optimizer as topt
from repro_torch.distributed import steps as tsteps
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import build_model
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.train.loop import make_step

LR = 1e-4
METRIC_TOL = 1e-4  # rtol of loss, ce, aux, mtp, acc and grad_norm
PARAM_ATOL = 2.2 * LR  # a first step moves an entry by ~lr·sign(g): a flipped sign is 2·lr
OFF_SHARE = 2e-3  # of entries past rtol 1e-4 / atol 1e-6 (near-zero gradients)
MOMENT_TOL = 1e-4  # of each moment's largest entry
B, S = 4, 32


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group and its (1, 1) mesh, gone after the file; torch
    on one thread meanwhile (the models are tiny, and the suite's other
    workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _temper(params, cfg):
    """``tests/test_torch_moe.py:_temper`` over the stacks a config has, and
    Zamba2's shared attention as ``tests/test_torch_zamba.py:_temper`` does
    (its width is 2·d_model) (numpy leaves)."""
    H = cfg.n_heads
    if cfg.attn_type == "mla":
        m = cfg.mla
        factors = {"wq_b": H / m.q_lora_rank, "wkv_b": H / m.kv_lora_rank, "wo": 1 / H}
    else:
        KV = cfg.n_kv_heads
        d = 2 * cfg.d_model if "shared" in params else cfg.d_model
        factors = {"wq": H / d, "wk": KV / d, "wv": KV / d, "wo": 1 / H}
    out = dict(params)
    for stack in ("dense_layers", "moe_layers", "shared"):
        if stack in params:
            attn = {k: v * factors[k] ** 0.5 if k in factors else v
                    for k, v in params[stack]["attn"].items()}
            out[stack] = {**params[stack], "attn": attn}
    return out


def _pair(arch, **moe):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if moe:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, **moe))
        tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe, **moe))
    jmodel = jax_build(jcfg)
    port = build_model(tcfg, device="cpu")
    params = _numpy(port.param_tree())
    if jcfg.family != "ssm":
        params = _temper(params, jcfg)
    load_params(port, params_from_jax(params))
    return jcfg, jmodel, params, port


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def jflatten(tree, prefix):
    return {_leaf_name(path, prefix): x for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(x):
    if is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype != torch.int8 else x.numpy()
    return np.asarray(x)


def _params_close(got, want):
    off = size = 0
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=0, atol=PARAM_ATOL, err_msg=name)
        off += int((~np.isclose(g, want[name], rtol=1e-4, atol=1e-6)).sum())
        size += g.size
    assert off <= OFF_SHARE * size, f"{off} of {size} entries past rtol 1e-4"


TRAIN = [
    ("olmo_1b", "tp", 1, None, False),
    ("olmo_1b", "dp", 2, "bfloat16", False),
    ("internlm2_1_8b", "dp", 1, None, False),
    ("internlm2_1_8b", "tp", 2, "bfloat16", False),
    ("deepseek_v3_671b", "tp", 1, None, False),
    ("deepseek_v3_671b", "dp", 2, "bfloat16", False),
    ("deepseek_v3_671b", "tp", 1, None, True),
    ("kimi_k2_1t", "tp", 1, None, False),
    # the Megatron split's other paths: qkv bias and padded heads; tied embedding,
    # QK-norm, sandwich norms; mm_proj and patches
    ("qwen2_5_14b", "tp", 1, None, False),
    ("gemma3_12b", "tp", 2, None, False),
    ("llava_next_mistral_7b", "tp", 1, "bfloat16", False),
]


def _batch(cfg, seed):
    """Tokens (B, S), and patch embeddings (B, P, d) for a vlm config, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.n_patches:
        batch["patch_embeds"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch,strategy,microbatches,grad_dtype,moe_ep", TRAIN,
                         ids=["-".join(map(str, c)) for c in TRAIN])
def test_train_step_matches_jax(mesh, arch, strategy, microbatches, grad_dtype, moe_ep):
    """Metrics, parameters and optimizer state after one step, each package's
    step from the same weights and batch (the moe family's capacity high
    enough that no route drops, so the expert-parallel and the dense
    dispatch agree)."""
    moe = {"capacity_factor": 8.0} if arch.startswith(("deepseek", "kimi")) else {}
    jcfg, jmodel, params, port = _pair(arch, **moe)
    kw = dict(lr=LR, warmup_steps=0, total_steps=10, moment_dtype=jcfg.opt_moment_dtype)
    batch = _batch(jcfg, 7)
    step_kw = dict(strategy=strategy, microbatches=microbatches, grad_dtype=grad_dtype,
                   moe_ep=moe_ep)

    jstep, in_sh, out_sh, _ = jsteps.make_train_step(
        jmodel, _jax_mesh(), JShape("t", "train", S, B), adamw=jopt.AdamWConfig(**kw), **step_kw)
    jstate = jax.jit(lambda p: jopt.init_state(p, jopt.AdamWConfig(**kw)))(params)
    jp, js, jm = jax.jit(jstep, in_shardings=in_sh, out_shardings=out_sh)(
        params, jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    tstep, (ppl, opl, _), _, (_, ometa) = tsteps.make_train_step(
        port, mesh, ShapeSpec("t", "train", S, B), adamw=topt.AdamWConfig(**kw), **step_kw)
    tsteps.shard_model(port, mesh, ppl)
    tstate = tsteps.init_opt_state(ometa, mesh, opl, "cpu")
    tp, ts, tm = tstep(port.param_tree(), tstate,
                       {k: torch.from_numpy(v) for k, v in batch.items()})

    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=METRIC_TOL, atol=1e-7,
                                   err_msg=k)
    want = {n: np.asarray(x, np.float32) for n, x in jflatten(jax.device_get(jp),
                                                              "param").items()}
    _params_close({n: _np(x) for n, x in flatten(tp, "param").items()}, want)
    jflat = jflatten(jax.device_get(js), "opt")
    tflat = flatten(ts, "opt")
    assert set(tflat) == set(jflat) and int(_np(ts["step"])) == 1
    # a bf16 gradient may round one ulp (2^-8) apart: m by that, v = 0.05·g² twice
    # that, an int8 code and its block's scale by one more
    flip = 2 ** -6 if grad_dtype else 0
    for name, t in tflat.items():
        got, exp = _np(t), np.asarray(jflat[name])
        if got.dtype == np.int8:
            gap = np.abs(got.astype(np.int32) - exp.astype(np.int32)).max()
            assert gap <= (2 if grad_dtype else 1), name
        elif name.endswith("scale"):
            np.testing.assert_allclose(got, exp, rtol=max(1e-2, flip), atol=1e-12, err_msg=name)
        elif got.ndim:
            np.testing.assert_allclose(got, exp, rtol=flip,
                                       atol=MOMENT_TOL * max(np.abs(exp).max(), 1e-12),
                                       err_msg=name)


def test_dp_step_is_make_steps_arithmetic_on_one_rank(mesh):
    """On one rank the ``dp`` step communicates nothing and adds no
    rounding: metrics and updated parameters bit-equal to ``make_step``'s."""
    _, _, _, a = _pair("olmo_1b")
    _, _, _, b = _pair("olmo_1b")  # the same weights: one process's init
    adamw = topt.AdamWConfig(lr=LR, warmup_steps=0)
    toks = torch.from_numpy(np.random.default_rng(8).integers(1, 512, (B, S)).astype(np.int32))
    a.requires_grad_(True)
    pa = a.param_tree()
    _, _, ma = make_step(a, adamw)(pa, topt.init_state(pa, adamw), {"tokens": toks})
    step, (ppl, opl, _), _, (_, ometa) = tsteps.make_train_step(
        b, mesh, ShapeSpec("t", "train", S, B), adamw=adamw, strategy="dp")
    tsteps.shard_model(b, mesh, ppl)
    _, _, mb = step(b.param_tree(), tsteps.init_opt_state(ometa, mesh, opl, "cpu"),
                    {"tokens": toks})
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for (name, x), (_, y) in zip(flatten(pa, "p").items(), flatten(b.param_tree(), "p").items()):
        assert torch.equal(x.detach(), y.detach()), name


@pytest.mark.parametrize("arch", ["qwen2_5_14b", "gemma3_12b", "llava_next_mistral_7b",
                                  "kimi_k2_1t", "deepseek_v3_671b"])
def test_split_train_step_is_make_steps_on_one_rank(mesh, arch):
    """On one rank the ``tp`` step's Megatron split is ``make_step``, op for
    op: metrics and updated parameters bit-equal (every collective the
    identity, the vocab-parallel cross-entropy ``cross_entropy_loss``'s
    arithmetic; the moe family's router, experts, MLA and MTP head too),
    and no weight gathered."""
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer

    _, _, _, a = _pair(arch)
    _, _, _, b = _pair(arch)
    adamw = topt.AdamWConfig(lr=LR, warmup_steps=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(a.cfg, 8).items()}
    a.requires_grad_(True)
    pa = a.param_tree()
    _, _, ma = make_step(a, adamw)(pa, topt.init_state(pa, adamw), batch)
    step, (ppl, opl, _), _, (_, ometa) = tsteps.make_train_step(
        b, mesh, ShapeSpec("t", "train", S, B), adamw=adamw)
    tsteps.shard_model(b, mesh, ppl)
    assert any(is_dtensor(p) for p in b.parameters())
    state = tsteps.init_opt_state(ometa, mesh, opl, "cpu")
    gathers = []
    kept = {(m, n): getattr(m, n) for m in (sharding, transformer) for n in ("gather",
                                                                              "gather_tree")}
    for (m, n), fn in kept.items():
        setattr(m, n, lambda *x, _n=n, _f=fn, **k: (gathers.append(_n), _f(*x, **k))[1])
    try:
        _, _, mb = step(b.param_tree(), state, batch)
    finally:
        for (m, n), fn in kept.items():
            setattr(m, n, fn)
    assert gathers == []
    assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
    for (name, x), (_, y) in zip(flatten(pa, "p").items(), flatten(b.param_tree(), "p").items()):
        assert torch.equal(x.detach(), _local(y).detach()), name


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def test_train_step_refuses_a_batch_that_does_not_split(mesh):
    from repro_torch.distributed import tensor_parallel

    _, _, _, port = _pair("olmo_1b")
    step, (ppl, opl, _), _, (_, ometa) = tsteps.make_train_step(
        port, mesh, ShapeSpec("t", "train", S, B), microbatches=3)
    tsteps.shard_model(port, mesh, ppl)
    state = tsteps.init_opt_state(ometa, mesh, opl, "cpu")
    with pytest.raises(ValueError, match="4 rows a rank do not split into 3 microbatches"):
        step(port.param_tree(), state, {"tokens": torch.ones((B, S), dtype=torch.int32)})
    # the split step's stored blocks are left as they were between steps
    assert not any(tensor_parallel.local(p).requires_grad for p in port.parameters())


@pytest.mark.parametrize("arch", ["qwen2_5_14b", "mamba2_780m", "zamba2_1_2b", "kimi_k2_1t",
                                  "deepseek_v3_671b"])
def test_prefill_and_decode_steps_match_jax(mesh, arch):
    """The reference's prefill and decode steps (jitted with their
    shardings) and the port's: the prompt's first S - 1 tokens right-padded
    to the capacity (the engine's way to make room), ``pos`` rewound, then
    three decode steps; logits at each, and the caches the port hands back
    keep the placements they took. The ssm and hybrid families' state would
    take the padding in, so they take the whole prompt: the port's Zamba2
    prefill makes room for the steps (``capacity``), and the reference's,
    which leaves none (``src/repro/models/ssm_lm.py:230-250``), has its K/V
    padded with zeros to the capacity."""
    jcfg, jmodel, params, port = _pair(arch)
    cap = S + 4
    prompts = np.random.default_rng(9).integers(1, jcfg.vocab, (B, S)).astype(np.int32)
    ssm = jcfg.family in ("ssm", "hybrid")
    toks = prompts if ssm else np.concatenate(
        [prompts[:, :S - 1], np.zeros((B, cap - S + 1), np.int32)], 1)
    jmesh = _jax_mesh()
    pre, psh, _, _ = jsteps.make_prefill_step(jmodel, jmesh, JShape("p", "prefill", toks.shape[1],
                                                                    B))
    dec, dsh, dout, _ = jsteps.make_decode_step(jmodel, jmesh, JShape("d", "decode", cap, B))
    jlog, jcache = jax.jit(pre, in_shardings=psh)(params, {"tokens": jnp.asarray(toks)})
    if jcfg.family == "hybrid":
        pad = [(0, 0)] * 3 + [(0, cap - S), (0, 0)]
        jcache = dict(jcache, attn={k: jnp.pad(v, pad) for k, v in jcache["attn"].items()})
    shape = ShapeSpec("p", "prefill", toks.shape[1], B)
    tpre, (ppl, _), _, _ = tsteps.make_prefill_step(port, mesh, shape, capacity=cap)
    tdec, (_, cpl, _), _, _ = tsteps.make_decode_step(port, mesh,
                                                      ShapeSpec("d", "decode", cap, B))
    tsteps.shard_model(port, mesh, ppl)
    with torch.inference_mode():
        tlog, tcache = tpre(port.param_tree(), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    nxt = prompts[:, -1:]
    if not ssm:
        jcache = dict(jcache, pos=jnp.asarray(S - 1, jnp.int32))
        tcache["pos"] = torch.tensor(S - 1, dtype=torch.int32)
        nxt = prompts[:, S - 1:S]
    jdec = jax.jit(dec, in_shardings=dsh, out_shardings=dout)
    placed = {p: t.placements for p, t in tsteps._leaves_with_paths(tcache) if is_dtensor(t)}
    for _ in range(3):
        jlog, jcache = jdec(params, jcache, jnp.asarray(nxt))
        with torch.inference_mode():
            tlog, tcache = tdec(port.param_tree(), tcache, torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=1e-4, atol=1e-4)
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        assert {p: t.placements for p, t in tsteps._leaves_with_paths(tcache)
                if is_dtensor(t)} == placed
    assert int(tcache["pos"]) == int(jcache["pos"])


@pytest.mark.parametrize("arch", ["qwen2_5_14b", "gemma3_12b", "llava_next_mistral_7b",
                                  "kimi_k2_1t", "deepseek_v3_671b", "mamba2_780m",
                                  "zamba2_1_2b"])
def test_split_serve_steps_are_the_models_own_on_one_rank(mesh, arch):
    """On one rank the Megatron split is the model's own serving, op for op:
    the prefill step's and every decode step's logits equal the unsharded
    model's ``prefill``/``decode_step`` bit for bit (qwen's bias and padded
    heads, gemma3's windows, QK-norm, sandwich norms and tied embedding,
    llava's patches, kimi's experts, deepseek's MLA latent cache, Mamba2's
    SSM state and conv windows, Zamba2's shared block), and every decode
    launch, the model's own too, is the kernel's slice call (one a layer;
    Zamba2's one an invocation of its shared block, Mamba2's none)."""
    from repro_torch.kernels import ref

    jcfg, _, params, port = _pair(arch)
    own = build_model(port.cfg, device="cpu")
    load_params(own, params_from_jax(params))
    cap = S + 4 + (port.cfg.n_patches or 0)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(1, jcfg.vocab, (B, S)).astype(np.int32))}
    if port.cfg.n_patches:
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, port.cfg.n_patches, port.cfg.d_model)).astype(np.float32))
    feed = torch.from_numpy(rng.integers(1, jcfg.vocab, (4, B, 1)).astype(np.int32))
    pre, (ppl, _), _, _ = tsteps.make_prefill_step(port, mesh, ShapeSpec("p", "prefill", S, B),
                                                   capacity=cap)
    dec, _, _, _ = tsteps.make_decode_step(port, mesh, ShapeSpec("d", "decode", cap, B))
    tsteps.shard_model(port, mesh, ppl)
    calls = []
    plain = ref.decode_attention_ref

    def counted(*args, **kw):
        calls.append(kw.get("return_lse", False))
        return plain(*args, **kw)
    ref.decode_attention_ref = counted
    try:
        with torch.inference_mode():
            args = [batch[k] for k in ("tokens", "patch_embeds") if k in batch]
            want, wcache = own.prefill(*args, capacity=cap)
            got, cache = pre(port.param_tree(), batch)
            assert torch.equal(got.full_tensor(), want)
            for tok in feed:
                want, wcache = own.decode_step(wcache, tok)
                got, cache = dec(port.param_tree(), cache, tok)
                assert torch.equal(got.full_tensor(), want)
    finally:
        ref.decode_attention_ref = plain
    attending = {"ssm": 0, "hybrid": len(getattr(port, "invocations", ()))}.get(
        port.cfg.family, port.cfg.n_layers)
    n = attending * len(feed)
    assert calls == [True] * (2 * n)  # the model's and the steps': slice calls, one a layer


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_initial_state_is_init_states(mesh, moments):
    """The sharded optimizer state starts as ``optimizer.init_state``'s:
    zero moments (a norm's ``scale`` leaf too), a quantized moment's scale
    at 1e-12, step 0."""
    port = build_model(get_config("internlm2_1_8b").reduced(), device="cpu")
    adamw = topt.AdamWConfig(moment_dtype=moments)
    for strategy in ("tp", "dp"):
        _, (_, opl, _), _, (_, ometa) = tsteps.make_train_step(
            port, mesh, ShapeSpec("t", "train", S, B), adamw=adamw, strategy=strategy)
        got = flatten(tsteps.init_opt_state(ometa, mesh, opl, "cpu"), "opt")
        want = flatten(topt.init_state(port.param_tree(), adamw), "opt")
        assert set(got) == set(want) and any("scale" in n for n in got)
        for name, t in want.items():
            g = got[name].full_tensor() if is_dtensor(got[name]) else got[name]
            assert g.dtype == t.dtype and torch.equal(g, t), (strategy, name)
