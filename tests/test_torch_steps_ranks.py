"""The port's sharded steps over several gloo ranks against one rank: 4 ranks
at meshes (2, 2), (4, 1) and (1, 4), and 2 ranks at (1, 2), each set
spawned once for the file (subprocesses meeting through a ``FileStore``).
The updated parameters, gathered, equal the one-rank step's; each rank
stores the reference's per-device block of every parameter and moment (the
JAX package's spec tables on an ``AbstractMesh`` of the same shape); the
int8 moments are quantized on whole blocks where a mesh cuts a block of
128. The ``tp`` train step of the dense, vlm and moe families runs the
Megatron split (the moe family's also over ``data``, the reference's FSDP
axis, where its leaves are bfloat16); no leaf is gathered over ``model``;
the moe family's step is one rank's step on the whole global batch, since
its dispatch routes the global batch over the ``data`` ranks. The serve
steps of the dense, vlm and moe families run the Megatron split: prefill
and decode equal one rank's, gather no weight and keep every cache leaf's
storage (the moe family's in the reference's placements); ``long_500k``'s
context-parallel decode (batch 1, the cache's sequence split over data ×
model) equals one rank's and, for gemma3, the reference's jitted step at
one device, and so does the moe family's (kimi's GQA, deepseek's MLA
latent cache) and the ssm and hybrid families' (Mamba2's SSM state and
conv windows split on their heads and channels over ``model``, Zamba2's
shared K/V over data × model), theirs against the reference's jitted step
too; the encdec family's context-parallel decode over several ranks raises,
naming ROADMAP item 18."""

import functools
import inspect
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.distributed import optimizer as jopt
from repro.distributed import partition as jpart
from repro.models import build_model as jax_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300
PARAM_TOL = 1e-5  # f32: the gathered parameters against one rank's
#: the split's gradients against one rank's, of each leaf's largest |entry|: f32
#: sums over the ranks' partial products (1.6e-6 seen)
SPLIT_GRAD_TOL = 1e-5
#: the split's whole step against one rank's: where |g| is near AdamW's eps (1e-8)
#: a first step moves an entry by lr·g/(|g| + eps), so the gradients' rounding
#: moves it by up to 2·lr (a sign), as ``tests/test_torch_steps.py:PARAM_ATOL``.
#: Seen over 2 and 4 ranks: InternLM2 4.3e-6, qwen 2.4e-5, gemma3 1.4e-5, llava
#: 2.7e-5, OLMo's int8 4.0e-5 (one moment code), past ``PARAM_TOL`` but for the first
SPLIT_STEP_ATOL = 2.2 * 3e-4
#: the bfloat16 cases (the moe family's FSDP axis live): each rank's gradient
#: blocks are rounded to bfloat16 before the reduce-scatter over ``data`` and the
#: reduce over ``model`` sum them in bfloat16, where one rank rounds each entry
#: once; with up to 4 ranks that parts an entry by a few bf16 ulps (2^-8 of it):
#: ``SPLIT_GRAD_TOL_BF16`` of each leaf's largest entry, the port's bf16 gradient
#: tolerance (the backward kernels', PERF.md §2). The AdamW step of those same
#: gradients then rounds the bf16 parameters, where one ulp of a leaf's largest
#: entry is up to 2^-8 of it: a bf16 case's parameter gaps are read past
#: ``BF16_ULP`` of each leaf's largest |entry| (then held to ``PARAM_TOL`` and
#: ``SPLIT_STEP_ATOL`` as the f32 cases')
SPLIT_GRAD_TOL_BF16 = 2e-2
BF16_ULP = 2 ** -8
#: a bf16 case's gradient norm (its entries each a few ulps apart) and int8
#: moment codes: a gradient entry a few bf16 ulps (~1%) off moves m's code
#: (127·m over its block's largest) by ~1 and v's (g²) by twice that, plus
#: one of rounding each (4 seen)
GRAD_NORM_RTOL_BF16 = BF16_ULP
INT8_CODE_GAP_BF16 = 6
#: the MLA (deepseek) f32 cases: the normed q_lora's gradient is the sum over
#: ``model`` of the ranks' heads' shares, and ``q_norm``'s gradient sums it over
#: every token, with cancellation, so f32 parts it by up to 1.1e-5 of its
#: largest entry (the next leaf 8.7e-6); in f64 the split parts the gradients
#: by 9e-7 (the cross-entropy and the router's logits stay f32, as in the
#: reference), so the split itself is sound
SPLIT_GRAD_TOL_MLA = 3e-5
MESHES = {4: [(2, 2), (4, 1), (1, 4)], 2: [(1, 2)]}
#: (arch, seed, batch, prompt, capacity) of the context-parallel decode: 199
#: prompt tokens in a cache of 256, so pos 199-201 lie in the last rank's rows
#: and the local layer's window of 64 crosses a slice boundary
CP_CASE = ("gemma3_12b", 3, 1, 200, 256)
CP_STEPS = 3
#: (arch, seed) of the moe family's serving: 8 prompts of 12 tokens in a cache of
#: 16 (their config's capacity factor 1.25, 1 dispatch chunk: a chunk over every
#: data rank), and batch 1 of 19 in 32 rows split over every rank (long_500k)
MOE_SERVE = [("kimi_k2_1t", 6), ("deepseek_v3_671b", 7)]
#: (arch, seed) of the ssm and hybrid families' serving (reduced: 8 SSM heads, G·N 16,
#: Zamba2's 4 shared heads of 64 tempered), as ``MOE_SERVE``'s: 8 prompts of 12 in a
#: cache of 16, and batch 1 of 19 in 32 rows over every rank (long_500k)
SSM_SERVE = [("mamba2_780m", 8), ("zamba2_1_2b", 9)]
#: (arch, moment dtype, sequence) of each strategy's train step. ``tp``: the
#: Megatron split for the dense and vlm families (InternLM2; reduced qwen: qkv
#: bias, 4 + 8 padded heads over 2 KV heads, which a model axis of 4 does not
#: divide, so ``wk``/``wv`` split on head_dim; gemma3: tied embedding, logit
#: softcap, QK-norm, a local layer of window 64 under 80 positions and a global
#: one; llava: ``mm_proj`` and 16 patches), the weights gathered a layer at a time
#: for the others (reduced Mamba2, with int8 moments on blocks the mesh cuts);
#: OLMo's int8 moments through the split. The split's cases run with the
#: attention tempered (``temper``): its partial sums round otherwise than one
#: rank's matmuls, and at the reference's init scales (ROADMAP.md §3 fault 4)
#: the f32 gradients then part by up to 3.1e-5 of a leaf's largest entry and
#: the gradient norm by 1.1e-5 (InternLM2), by 1.6e-6 and 0 tempered; in f64 the
#: same untempered weights part by 2.3e-6 (the cross-entropy is f32 in both
#: packages), so the split itself is sound. ``dp`` runs the reference's init.
#: The moe family's cases (a case is ``arch`` or ``arch@variant``, its config
#: changed by ``TRAIN_CHANGES``; ``ep`` in the variant runs ``moe_ep``): reduced
#: kimi (GQA) and deepseek (MLA, the MTP head), f32 and bfloat16 (the FSDP axis
#: live at data >= 2; remat and 2 dispatch chunks), with and without ``moe_ep``, at a
#: capacity factor of 8 so that no route drops. The dispatch routes the global
#: batch over the data ranks (its chunks, their capacity and the aux loss are the
#: global batch's, ``models/moe.py:_rows_dispatch``), so these cases are held to
#: one rank's step on the whole global batch; with ``moe_ep`` each rank routes its
#: own rows, as the reference's expert-parallel FFN does, so those are held to one
#: rank's step on each of the data × model row blocks, averaged (:func:`one_rank`'s
#: ``blocks``).
TRAIN_CASES = {
    "tp": [("internlm2_1_8b", "float32", 32), ("qwen2_5_14b", "float32", 32),
           ("gemma3_12b", "float32", 80), ("llava_next_mistral_7b", "float32", 32),
           ("olmo_1b", "int8", 32), ("mamba2_780m", "int8", 32),
           ("kimi_k2_1t", "float32", 32), ("kimi_k2_1t@bf16", "int8", 32),
           ("kimi_k2_1t@bf16_ep", "int8", 32), ("deepseek_v3_671b", "float32", 32),
           ("deepseek_v3_671b@ep", "float32", 32), ("deepseek_v3_671b@bf16", "int8", 32)],
    "dp": [("internlm2_1_8b", "float32", 32), ("olmo_1b", "int8", 32),
           ("kimi_k2_1t", "float32", 32)],
}
_NO_DROPS = {"capacity_factor": 8.0}
_BF16 = {"param_dtype": "bfloat16", "remat": True,
         "moe": {"capacity_factor": 8.0, "dispatch_chunks": 2}}
TRAIN_CHANGES = {"gemma3_12b": {"global_every": 2, "logit_softcap": 30.0},
                 "kimi_k2_1t": {"moe": _NO_DROPS}, "kimi_k2_1t@bf16": _BF16,
                 "kimi_k2_1t@bf16_ep": _BF16, "deepseek_v3_671b": {"moe": _NO_DROPS},
                 "deepseek_v3_671b@ep": {"moe": _NO_DROPS}, "deepseek_v3_671b@bf16": _BF16}


def changed(cfg, case, changes):
    """``cfg`` with ``case``'s changes (a ``moe`` entry replaces fields of
    ``cfg.moe``): in the rank processes and in this one alike."""
    import dataclasses

    kw = dict(changes.get(case, {}))
    if "moe" in kw:
        kw["moe"] = dataclasses.replace(cfg.moe, **kw["moe"])
    return cfg.with_(**kw)

_RANKS = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
rank, world = int(os.environ["RA_RANK"]), int(os.environ["RA_WORLD"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["RA_STORE"], world),
                        rank=rank, world_size=world)
try:
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.distributed import optimizer as optim, steps
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import build_model, ssm_lm, transformer
    from repro_torch.train.loop import make_step

    B = 8
    TRAIN_CASES = json.loads(os.environ["RA_TRAIN_CASES"])
    CP_CASE = json.loads(os.environ["RA_CP_CASE"])
    MOE_SERVE = json.loads(os.environ["RA_MOE_SERVE"])
    SSM_SERVE = json.loads(os.environ["RA_SSM_SERVE"])
    out = {}

    def train_config(case):
        return changed(get_config(case.split("@")[0]).reduced(), case, TRAIN_CHANGES)

    def moe_ep(case):
        return "ep" in case.partition("@")[2]

    def batch_for(cfg, S):
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab, (B, S)).astype(np.int32))}
        if cfg.n_patches:
            batch["patch_embeds"] = torch.from_numpy(
                rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32))
        return batch

    def split_case(strategy, arch):
        return strategy == "tp" and build_model(train_config(arch), device="meta").train_splits

    def train_model(arch, tempered):
        model = build_model(train_config(arch), device="cpu", seed=1)
        if tempered:  # the split's f32 rounding, not amplified by the init
            temper(model)
        return model

    def one_rank(arch, moments, S, tempered, blocks=0):
        # blocks (the moe family): the gradients and the loss are the means of
        # one rank's over that many equal row blocks of the batch, and the step
        # is one rank's AdamW of those gradients
        cfg = train_config(arch)
        batch = batch_for(cfg, S)
        if blocks:
            grads, losses = {}, []
            for part in batch["tokens"].chunk(blocks):
                model = train_model(arch, tempered)
                model.requires_grad_(True)
                loss, _ = model.train_loss({"tokens": part})
                loss.backward()
                losses.append(loss.detach())
                for k, p in steps._leaves_with_paths(model.param_tree()):
                    grads[k] = grads.get(k, 0) + p.grad.float() / blocks
            params, state, info = update_of(arch, moments, grads, tempered)
            return params, state, {"loss": torch.stack(losses).mean(), **info}, grads
        model = train_model(arch, tempered)
        model.requires_grad_(True)
        loss, _ = model.train_loss(batch)
        loss.backward()
        grads = {k: p.grad for k, p in steps._leaves_with_paths(model.param_tree())}
        model = train_model(arch, tempered)
        model.requires_grad_(True)
        adamw = optim.AdamWConfig(moment_dtype=moments, warmup_steps=0)
        params = model.param_tree()
        state = optim.init_state(params, adamw)
        _, state, metrics = make_step(model, adamw)(params, state, batch)
        return dict(steps._leaves_with_paths(params)), state, metrics, grads

    def update_of(arch, moments, grads, tempered=True):
        # one rank's AdamW step from the case's initial weights with the given
        # gradients: (parameters, state, {"lr", "grad_norm"})
        model = train_model(arch, tempered)
        adamw = optim.AdamWConfig(moment_dtype=moments, warmup_steps=0)
        params = model.param_tree()

        def like(node, path=""):  # the params' tree (OLMo's empty ln_f too), the grads' leaves
            if isinstance(node, dict):
                return {k: like(v, f"{path}/{k}" if path else k) for k, v in node.items()}
            return grads[path].to(model_leaf(params, path).dtype)
        tree = like(params)
        with torch.no_grad():
            _, state, info = optim.apply_updates(params, tree, optim.init_state(params, adamw),
                                                 adamw)
        return dict(steps._leaves_with_paths(params)), state, info

    def model_leaf(params, path):
        for k in path.split("/"):
            params = params[k]
        return params

    def counting_gathers(found):
        # every weight gather (as the models call them, and the train step's
        # autograd gather) noted in ``found``, passed through; the autograd
        # gather's as "model" where it gathers a block split over model whole
        # there, else "data" where it gathers over another axis (the FSDP
        # axis), else "experts" (the experts moved to dim 0 over model)
        saved = {}
        for mod, name in ((sh, "gather"), (sh, "gather_tree"), (transformer, "gather"),
                          (transformer, "gather_tree"), (sh._Gather, "apply")):
            saved[(mod, name)] = fn = getattr(mod, name)
            setattr(mod, name, lambda *a, _n=name, _f=fn, **k: (found.append(_n), _f(*a, **k))[1])
        gather = saved[(sh._Gather, "apply")]

        def gather_kind(anchor, local, mesh, src, target, *rest):
            over = {name for j, name in enumerate(mesh.mesh_dim_names) if mesh.size(j) > 1
                    and isinstance(src[j], Shard) and isinstance(target[j], Replicate)}
            found.append("model" if "model" in over else "data" if over else "experts")
            return gather(anchor, local, mesh, src, target, *rest)
        sh._Gather.apply = gather_kind
        return saved

    def full(t):
        return t.full_tensor() if sh.is_dtensor(t) else t

    def temper(model):
        # the attention weights scaled as tests/test_torch_steps.py:_temper does,
        # in each stack a config has (Zamba2's shared block 2·d_model wide)
        cfg = model.cfg
        H, KV = cfg.n_heads, cfg.n_kv_heads
        d = 2 * cfg.d_model if hasattr(model, "shared") else cfg.d_model
        if cfg.attn_type == "mla":
            m = cfg.mla
            factors = {"wq_b": H / m.q_lora_rank, "wkv_b": H / m.kv_lora_rank, "wo": 1 / H}
        else:
            factors = {"wq": H / d, "wk": KV / d, "wv": KV / d, "wo": 1 / H}
        with torch.no_grad():
            for stack in ("dense_layers", "moe_layers", "shared"):
                if hasattr(model, stack):
                    for name, f in factors.items():
                        getattr(getattr(model, stack).attn, name).mul_(f ** 0.5)

    def config(arch):
        cfg = get_config(arch).reduced()
        return cfg.with_(global_every=2) if arch == "gemma3_12b" else cfg

    def serve_case(arch, seed, B, S, cap, cp=False, patches=False, steps_n=3):
        # prefill (the prompt's first S - 1 tokens padded to the capacity where
        # cp, pos then rewound) and decode steps of fixed random tokens, through
        # the steps over the mesh and through the plain model in this process
        cfg = config(arch)
        plain, model = (build_model(cfg, device="cpu", seed=seed) for _ in range(2))
        temper(plain)
        temper(model)
        rng = np.random.default_rng(seed)
        prompts = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S)).astype(np.int32))
        feed = torch.from_numpy(rng.integers(1, cfg.vocab, (steps_n, B, 1)).astype(np.int32))
        if cp:
            feed = torch.cat([prompts[None, :, S - 1:], feed[1:]])
            prompts = torch.cat([prompts[:, :S - 1],
                                 torch.zeros((B, cap - S + 1), dtype=torch.int32)], 1)
        batch = {"tokens": prompts}
        if patches:
            batch["patch_embeds"] = torch.from_numpy(
                rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32))
        args = [batch[k] for k in ("tokens", "patch_embeds") if k in batch]
        with torch.inference_mode():
            l0, c0 = plain.prefill(*args, capacity=cap)
            if cp:
                c0["pos"] = torch.tensor(S - 1, dtype=torch.int32)
            want = [plain.decode_step(c0, feed[i])[0] for i in range(steps_n)]
        pre, (ppl, _), _, _ = steps.make_prefill_step(
            model, mesh, ShapeSpec("p", "prefill", prompts.shape[1], B, context_parallel=cp),
            capacity=cap)
        dec, _, _, _ = steps.make_decode_step(
            model, mesh, ShapeSpec("d", "decode", cap, B, context_parallel=cp))
        steps.shard_model(model, mesh, ppl)
        gathers = []
        saved = {}
        for mod, names in ((sh, ("gather", "gather_tree")), (transformer, ("gather", "gather_tree")),
                           (ssm_lm, ("gather_tree",))):
            for name in names:
                saved[(mod, name)] = getattr(mod, name)
                setattr(mod, name, lambda *a, _n=name, **k: gathers.append(_n))
        try:
            with torch.inference_mode():
                g0, cache = pre(model.param_tree(), batch)
                took = {k: str(t.placements) for k, t in steps._leaves_with_paths(cache)
                        if sh.is_dtensor(t)}
                if cp:
                    cache["pos"] = torch.tensor(S - 1, dtype=torch.int32)
                ptrs = {k: t.to_local().data_ptr() for k, t in steps._leaves_with_paths(cache)
                        if sh.is_dtensor(t)}
                got, kept_storage = [], True
                for i in range(steps_n):
                    g, cache = dec(model.param_tree(), cache, feed[i])
                    got.append(g.full_tensor())
                    kept_storage &= ptrs == {k: t.to_local().data_ptr() for k, t in
                                             steps._leaves_with_paths(cache) if sh.is_dtensor(t)}
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
        kept = {k: str(t.placements) for k, t in steps._leaves_with_paths(cache)
                if sh.is_dtensor(t)}
        res = {"prefill": float((g0.full_tensor() - l0).abs().max()),
               "decode": max(float((g - w).abs().max()) for g, w in zip(got, want)),
               "scale": float(l0.abs().max()), "same_placements": took == kept and bool(took),
               "storage_kept": kept_storage, "gathers": len(gathers),
               "logits_placements": str(g0.placements), "cache_placements": took}
        if cp:
            res["decode_logits"] = [g.tolist() for g in got]
        return res

    want = {}
    for shape in map(tuple, json.loads(os.environ["RA_MESHES"])):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        for strategy, cases in TRAIN_CASES.items():
            for arch, moments, S in cases:
                cfg = train_config(arch)
                blocks = 0
                if moe_ep(arch):  # each rank routes its own rows
                    blocks = shape[0] * shape[1]
                key = (strategy, arch, moments, blocks)
                if key not in want:
                    want[key] = one_rank(arch, moments, S, split_case(strategy, arch), blocks)
                model = train_model(arch, split_case(strategy, arch))
                adamw = optim.AdamWConfig(moment_dtype=moments, warmup_steps=0)
                step, (ppl, opl, _), _, (_, ometa) = steps.make_train_step(
                    model, mesh, ShapeSpec("t", "train", S, B), adamw=adamw, strategy=strategy,
                    moe_ep=moe_ep(arch))
                steps.shard_model(model, mesh, ppl)
                state = steps.init_opt_state(ometa, mesh, opl, "cpu")
                params = model.param_tree()
                gathers, seen = [], {}
                saved = counting_gathers(gathers)
                apply = steps._apply_updates

                def spy(params, leaves, grads, *a, **k):  # the gradients the update takes
                    seen.update({p: g.detach().clone() for p, g in grads.items()})
                    return apply(params, leaves, grads, *a, **k)
                steps._apply_updates = spy
                try:
                    _, state, metrics = step(params, state, batch_for(cfg, S))
                finally:
                    steps._apply_updates = apply
                    for (mod, name), fn in saved.items():
                        setattr(mod, name, fn)
                p1, s1, m1, g1 = want[key]
                bf16 = cfg.pdtype == torch.bfloat16

                def gap(got, ref):  # past one bf16 ulp of the leaf's largest entry, for bf16
                    ref = ref.detach().float()
                    return float((got.detach().float() - ref).abs().max()) - \
                        (BF16_ULP * float(ref.abs().max()) if bf16 else 0.0)
                diff = max(gap(full(t), p1[k]) for k, t in steps._leaves_with_paths(params))
                res = {}
                if split_case(strategy, arch):
                    # the step's gradients, whole, against one rank's; its update against
                    # one rank's AdamW of those same gradients
                    whole = {k: full(steps._dtensor(seen[k], mesh, t.placements, tuple(t.shape)))
                             if sh.is_dtensor(t) else seen[k]
                             for k, t in steps._leaves_with_paths(params)}
                    res["grad_err"] = max(float((whole[k].float() - g1[k].float()).abs().max() /
                                                g1[k].float().abs().max().clamp_min(1e-30))
                                          for k in g1)
                    same = update_of(arch, moments, whole)[0]
                    res["step_param_diff"] = diff
                    diff = max(gap(full(t), same[k]) for k, t in steps._leaves_with_paths(params))
                codes = 0
                for part in ("m", "v"):
                    ref = dict(steps._leaves_with_paths(s1[part]))
                    for k, t in steps._leaves_with_paths(state[part]):
                        if t.dtype == torch.int8:
                            codes = max(codes, int((full(t).int() - ref[k].int()).abs().max()))
                shapes = {"param/" + k: list((t.to_local() if sh.is_dtensor(t) else t).shape)
                          for k, t in steps._leaves_with_paths(params)}
                for part in ("m", "v"):
                    shapes.update({f"{part}/{k}": list(t.to_local().shape)
                                   for k, t in steps._leaves_with_paths(state[part])})
                out[f"{shape}/{strategy}/{arch}/{moments}"] = {
                    "param_diff": diff, "int8_code_gap": codes, "shapes": shapes,
                    "gathers": sum(g not in ("model", "data", "experts") for g in gathers),
                    "model_gathers": gathers.count("model"),
                    "data_gathers": gathers.count("data"), "bf16": bf16,
                    "split": model.train_splits, **res,
                    "loss": [float(metrics["loss"]), float(m1["loss"])],
                    "grad_norm": [float(metrics["grad_norm"]), float(m1["grad_norm"])]}

        # the int8 update on blocks a mesh cuts (and past the padding) against one rank's
        cuts = {}
        torch.manual_seed(0)
        ad = optim.AdamWConfig(moment_dtype="int8")
        last = "model" if shape[1] > 1 else "data"
        for n in (128, 48):
            p, g = torch.randn(6, n), torch.randn(6, n)
            m0, v0 = optim.quantize_blockwise(torch.randn(6, n) * 0.1), \
                optim.quantize_blockwise(torch.rand(6, n) * 0.01)
            pr = p.clone()
            mr = {k: t.clone() for k, t in m0.items()}
            vr = {k: t.clone() for k, t in v0.items()}
            lr, b1c, b2c = torch.tensor(1e-3), torch.tensor(0.19), torch.tensor(0.0975)
            optim._update(pr, g, mr, vr, 0.5, lr, b1c, b2c, ad)
            pl = sh.placements((None, last), mesh, 2)
            spl = sh.placements((None, None), mesh, 2)

            def put(mom):
                return {"q": steps._dtensor(steps._block(mom["q"], mesh, pl).clone(), mesh, pl,
                                            mom["q"].shape),
                        "scale": steps._dtensor(mom["scale"].clone(), mesh, spl,
                                                mom["scale"].shape)}
            M, V = put(m0), put(v0)
            pb = steps._block(p, mesh, pl).clone()
            steps._update_leaf(pb, steps._block(g, mesh, pl), M, V, 0.5, lr, b1c, b2c, ad, mesh,
                               n)
            cuts[str(n)] = {
                "local": list(M["q"].to_local().shape),
                "p": torch.equal(pb, steps._block(pr, mesh, pl)),
                "q": torch.equal(M["q"].full_tensor(), mr["q"]) and
                torch.equal(V["q"].full_tensor(), vr["q"]),
                "scale": torch.equal(M["scale"].full_tensor(), mr["scale"]) and
                torch.equal(V["scale"].full_tensor(), vr["scale"])}
        out[f"{shape}/cuts"] = cuts

        # serving over the mesh, the Megatron split: logits equal one process's, no
        # weight gathered, every cache leaf's storage kept; qwen's 2 KV heads do not
        # divide a model axis of 4 (wk/wv split on head_dim); llava adds mm_proj
        out[f"{shape}/serve"] = serve_case("qwen2_5_14b", 2, 8, 12, 16)
        out[f"{shape}/serve_vlm"] = serve_case("llava_next_mistral_7b", 4, 4, 12, 32,
                                               patches=True)
        # the moe family: kimi's GQA, deepseek's MLA latent cache, the experts' blocks,
        # the dispatch routing the global batch over the data ranks
        for arch, seed in MOE_SERVE:
            out[f"{shape}/serve_{arch}"] = serve_case(arch, seed, 8, 12, 16)
            out[f"{shape}/serve_cp_{arch}"] = serve_case(arch, seed, 1, 20, 32, cp=True)
        # the ssm and hybrid families: the SSM heads and channels over model, Zamba2's
        # shared block on its heads and cache rows
        for arch, seed in SSM_SERVE:
            out[f"{shape}/serve_{arch}"] = serve_case(arch, seed, 8, 12, 16)
            out[f"{shape}/serve_cp_{arch}"] = serve_case(arch, seed, 1, 20, 32, cp=True)
        # long_500k's split: batch 1, the cache's sequence over data x model
        out[f"{shape}/serve_cp"] = serve_case(*CP_CASE, cp=True)
        refused = {}
        for arch in ("whisper_medium",):  # encdec
            try:
                other = build_model(get_config(arch).reduced(), device="cpu", seed=2)
                cp = steps.make_decode_step(other, mesh, ShapeSpec("l", "decode", 16, 1,
                                                                   context_parallel=True))[0]
                cp(other.param_tree(), {}, torch.zeros((1, 1), dtype=torch.int32))
                refused[arch] = ""
            except NotImplementedError as e:
                refused[arch] = str(e)
        out[f"{shape}/serve"]["refused"] = refused
        # constrain drops an axis that does not divide the dim
        x5 = steps._dtensor(torch.zeros(5, 4), mesh, [Replicate(), Replicate()], (5, 4))
        x8 = steps._dtensor(torch.zeros(8, 4), mesh, [Replicate(), Replicate()], (8, 4))
        with sh.use_rules(sh.train_rules(False), mesh):
            c5 = sh.constrain(x5, "batch", "embed").placements
            c8 = sh.constrain(x8, "batch", "embed").placements
        out[f"{shape}/serve"]["constrain"] = [str(c5), str(c8)]
    print(json.dumps({"rank": rank, "out": out}))
finally:
    dist.destroy_process_group()
"""


def _spawn(world, tmp):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")])),
        RA_STORE=str(tmp / f"store{world}"), RA_WORLD=str(world), OMP_NUM_THREADS="1",
        RA_MESHES=json.dumps(MESHES[world]), RA_CP_CASE=json.dumps(CP_CASE),
        RA_MOE_SERVE=json.dumps(MOE_SERVE), RA_SSM_SERVE=json.dumps(SSM_SERVE),
        RA_TRAIN_CASES=json.dumps(TRAIN_CASES))
    script = (f"TRAIN_CHANGES = {TRAIN_CHANGES!r}\nBF16_ULP = {BF16_ULP!r}\n" +
              inspect.getsource(changed) + _RANKS)
    procs = [subprocess.Popen([sys.executable, "-c", script], env=dict(env, RA_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, err[-4000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {o["rank"]: o["out"] for o in outs}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: {rank: results}} of the 4-rank and the 2-rank sets."""
    tmp = tmp_path_factory.mktemp("steps_ranks")
    return {world: _spawn(world, tmp) for world in sorted(MESHES)}


CASES = [(world, tuple(shape)) for world in sorted(MESHES) for shape in MESHES[world]]
IDS = ["x".join(map(str, s)) for _, s in CASES]


def _abstract(shape):
    names = ("data", "model")
    try:
        return AbstractMesh(tuple(zip(names, shape)))
    except TypeError:
        return AbstractMesh(shape, names)


def _reference_blocks(shape, strategy, arch, moments):
    """{leaf: per-device block shape} by the JAX package's tables for the
    reduced ``arch`` on a ``shape`` mesh, the rank's coordinates aside."""
    cfg = changed(jax_config(arch.split("@")[0]).reduced(), arch, TRAIN_CHANGES)
    model = jax_build(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    adamw = jopt.AdamWConfig(moment_dtype=moments)
    opt = jax.eval_shape(lambda: jopt.init_state(params, adamw))
    mesh = _abstract(shape)
    sizes = dict(zip(("data", "model"), shape))
    pspecs = jpart.param_specs(params, cfg, mesh, strategy=strategy)
    ospecs = (jpart.zero1_moment_specs(opt, mesh) if strategy == "dp"
              else jpart.opt_state_specs(opt, pspecs))

    def block(leaf, spec):
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(tuple(spec)))
        out = []
        for dim, axes in zip(leaf.shape, spec):
            axes = () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
            out.append(dim // int(np.prod([sizes[a] for a in axes])))
        return out

    def flat(tree, specs, prefix):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
        return {prefix + "/".join(str(getattr(k, "key", k)) for k in path): block(leaf, sp)
                for (path, leaf), sp in zip(leaves, spec_leaves)}

    want = flat(params, pspecs, "param/")
    for part in ("m", "v"):
        want.update(flat(opt[part], ospecs[part], f"{part}/"))
    return want


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
@pytest.mark.parametrize("strategy", ["tp", "dp"])
def test_several_ranks_give_the_one_rank_step(ranks, world, shape, strategy):
    """Each case of ``TRAIN_CASES`` (InternLM2: GQA, norm scales replicated, f32
    moments; OLMo: int8 moments; under ``tp`` these and qwen, gemma3, llava,
    kimi and deepseek through the Megatron split, Mamba2 through the
    gathered weights; under ``dp`` kimi too, its dispatch over every rank's
    rows): the gathered parameters within 1e-5 of one rank's
    step, the loss and gradient norm within f32 rounding (a leaf replicated
    over ``model`` counted once in the norm), the int8 codes at most one
    apart (the gradients' sums differ by rounding). The split step gathers
    no weight over ``model`` (the bf16 moe cases gather each layer's blocks
    over ``data`` where it has several ranks: the FSDP axis); its gradients
    are one rank's within ``SPLIT_GRAD_TOL`` (bf16: ``SPLIT_GRAD_TOL_BF16``),
    its parameters one rank's AdamW step of those gradients within
    ``PARAM_TOL`` (and one rank's whole step within ``SPLIT_STEP_ATOL``:
    entries whose gradient is near AdamW's eps move by far more than the
    gradient's rounding; bf16 parameters past one ulp of their leaf's
    largest entry)."""
    for arch, moments, _ in TRAIN_CASES[strategy]:
        for rank, out in ranks[world].items():
            got = out[f"{shape}/{strategy}/{arch}/{moments}"]
            assert got["param_diff"] <= PARAM_TOL, (rank, arch, got["param_diff"])
            bf16 = got["bf16"]
            np.testing.assert_allclose(*got["loss"], rtol=1e-6, err_msg=arch)
            np.testing.assert_allclose(*got["grad_norm"], rtol=GRAD_NORM_RTOL_BF16 if bf16
                                       else 1e-6, err_msg=arch)
            assert got["int8_code_gap"] <= (INT8_CODE_GAP_BF16 if bf16 else 1), (arch, got)
            if got["split"]:
                assert got["gathers"] == 0 and got["model_gathers"] == 0, (arch, got)
                assert (got["data_gathers"] > 0) == (got["bf16"] and shape[0] > 1), (arch, got)
            else:
                assert got["gathers"] > 0, arch
            if "grad_err" in got:
                tol = (SPLIT_GRAD_TOL_BF16 if bf16 else SPLIT_GRAD_TOL_MLA
                       if arch.startswith("deepseek") else SPLIT_GRAD_TOL)
                assert got["grad_err"] <= tol, (rank, arch, got["grad_err"])
                assert got["step_param_diff"] <= SPLIT_STEP_ATOL, (rank, arch)
        assert got["split"] == (arch != "mamba2_780m"), arch  # dp: one rank's split, whole


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
@pytest.mark.parametrize("strategy", ["tp", "dp"])
def test_each_rank_stores_the_reference_block(ranks, world, shape, strategy):
    for arch, moments, _ in TRAIN_CASES[strategy]:
        want = _reference_blocks(shape, strategy, arch, moments)
        for out in ranks[world].values():
            assert out[f"{shape}/{strategy}/{arch}/{moments}"]["shapes"] == want


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
def test_int8_moments_on_cut_blocks_equal_one_rank(ranks, world, shape):
    """A 128-wide row split 2 or 4 ways (and a 48-wide one, whose padding to
    128 sits on other ranks): codes and scales equal ``quantize_blockwise``'s
    on one rank, bit for bit, and so does the parameter."""
    for out in ranks[world].values():
        cuts = out[f"{shape}/cuts"]
        assert cuts["128"]["local"] == [6, 128 // max(shape)]
        for n, got in cuts.items():
            assert got["p"] and got["q"] and got["scale"], (n, got)


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
def test_serving_over_the_mesh(ranks, world, shape):
    """Prefill and decode over the mesh, split Megatron-style, equal one
    process's logits (qwen's 2 KV heads, which a model axis of 4 does not
    divide, llava's ``mm_proj`` and patches, kimi's GQA and deepseek's MLA
    with their experts' blocks and the dispatch over the data ranks among
    them, Mamba2's SSM heads and channels and Zamba2's shared block), gather
    no weight, keep each cache leaf's storage and placements (the moe, ssm
    and hybrid families' the reference's ``cache_spec_tree``'s), and give
    logits split on the vocab over ``model``; the encdec family's
    context-parallel steps over several ranks raise naming ROADMAP item 18
    (the others' no longer do: ``test_context_parallel_decode_over_the_mesh``,
    ``test_moe_context_parallel_decode_over_the_mesh``,
    ``test_ssm_context_parallel_decode_over_the_mesh``); and ``constrain``
    drops an axis that does not divide (5 rows over 2 or 4 data ranks) and
    keeps one that does."""
    moe = [f"serve_{arch}" for arch, _ in MOE_SERVE + SSM_SERVE]
    for out in ranks[world].values():
        for case in ["serve", "serve_vlm"] + moe:
            got = out[f"{shape}/{case}"]
            assert got["prefill"] <= 1e-5 * got["scale"], (case, got["prefill"], got["scale"])
            assert got["decode"] <= 1e-4 * got["scale"], (case, got["decode"], got["scale"])
            assert got["same_placements"] and got["storage_kept"], case
            assert got["gathers"] == 0, case
            assert ("Shard(dim=1)" in got["logits_placements"]) == (shape[1] > 1), case
        for arch, _ in MOE_SERVE + SSM_SERVE:
            got = out[f"{shape}/serve_{arch}"]["cache_placements"]
            assert {k: v for k, v in got.items() if not k.endswith("/kv")} == \
                _reference_cache_placements(arch, shape, 8, 16, False), arch
        got = out[f"{shape}/serve"]
        assert list(got["refused"]) == ["whisper_medium"]
        for arch, refused in got["refused"].items():
            assert "ROADMAP.md item 18" in refused, arch
        c5, c8 = got["constrain"]
        assert ("Shard" in c5) == (shape[0] == 1)  # 5 rows divide over 1 data rank only
        assert c8.startswith("(Shard(dim=0)")


def _reference_cache_placements(arch, shape, B, cap, cp):
    """{cache leaf: the placements, as the port prints them} that the
    reference's ``cache_spec_tree`` gives the reduced ``arch``'s cache of
    ``B`` × ``cap`` on a ``shape`` mesh (the port's MLA ``kv`` stack, whose
    column views are the reference's ``latent`` and ``k_rope``, aside)."""
    from repro.distributed import steps as jsteps
    from repro.launch.shapes import ShapeSpec as JShape

    jmodel = jax_build(jax_config(arch).reduced())
    cache = jax.eval_shape(lambda: jmodel.empty_cache(B, cap))
    specs = jsteps.cache_spec_tree(cache, JShape("s", "decode", cap, B, context_parallel=cp),
                                   _abstract(shape), False)
    names = ("data", "model")
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        if key == "pos":
            continue
        pl = []
        for name in names:
            dims = [i for i, e in enumerate(spec) if e is not None and
                    name in ((e,) if isinstance(e, str) else tuple(e))]
            pl.append(f"Shard(dim={dims[0]})" if dims else "Replicate()")
        out[key] = "(" + ", ".join(pl) + ")"
    return out


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
def test_moe_context_parallel_decode_over_the_mesh(ranks, world, shape):
    """``long_500k``'s split for the moe family at a tiny size (reduced kimi
    and deepseek, batch 1, a cache of 32 rows split over every rank, pos
    19–21 in one rank's rows): prefill and decode logits equal one
    process's, no weight gathered, each cache leaf's storage kept, in the
    reference's placements (deepseek's ``latent``/``k_rope`` on their dim 2
    over data × model)."""
    for out in ranks[world].values():
        for arch, _ in MOE_SERVE:
            got = out[f"{shape}/serve_cp_{arch}"]
            assert got["prefill"] <= 1e-5 * got["scale"], (arch, got["prefill"], got["scale"])
            assert got["decode"] <= 1e-4 * got["scale"], (arch, got["decode"], got["scale"])
            assert got["same_placements"] and got["storage_kept"] and got["gathers"] == 0, arch
            want = _reference_cache_placements(arch, shape, 1, 32, True)
            assert {k: v for k, v in got["cache_placements"].items() if not k.endswith("/kv")} \
                == want, arch


@functools.lru_cache(maxsize=None)
def _cp_reference(arch, seed, B, S, cap):
    """The reference's jitted prefill and decode steps at one device on a
    context-parallel case (``long_500k``'s specs: batch 1, the KV length over
    data × model), with the ranks' tempered weights and tokens: the decode
    logits."""
    import jax.numpy as jnp
    import torch

    from repro.distributed import steps as jsteps
    from repro.launch.shapes import ShapeSpec as JShape
    from repro_torch.configs import get_config
    from repro_torch.models import build_model as port_build

    changes = {"global_every": 2} if arch == "gemma3_12b" else {}
    port = port_build(get_config(arch).reduced().with_(**changes), device="cpu", seed=seed)
    cfg = port.cfg
    H, KV = cfg.n_heads, cfg.n_kv_heads
    d = 2 * cfg.d_model if hasattr(port, "shared") else cfg.d_model
    with torch.no_grad():  # the ranks' temper()
        for stack in ("dense_layers", "shared"):
            if hasattr(port, stack):
                for name, f in (("wq", H / d), ("wk", KV / d), ("wv", KV / d), ("wo", 1 / H)):
                    getattr(getattr(port, stack).attn, name).mul_(f ** 0.5)

    def numpy(tree):
        if isinstance(tree, dict):
            return {k: numpy(v) for k, v in tree.items()}
        return tree.detach().numpy().copy()

    params = numpy(port.param_tree())
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    feed = rng.integers(1, cfg.vocab, (CP_STEPS, B, 1)).astype(np.int32)
    feed = np.concatenate([prompts[None, :, S - 1:], feed[1:]])
    toks = np.concatenate([prompts[:, :S - 1], np.zeros((B, cap - S + 1), np.int32)], 1)
    jmodel = jax_build(jax_config(arch).reduced().with_(**changes))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    pre, psh, _, _ = jsteps.make_prefill_step(jmodel, jmesh, JShape("p", "prefill", cap, B,
                                                                    context_parallel=True))
    dec, dsh, dout, _ = jsteps.make_decode_step(jmodel, jmesh, JShape("d", "decode", cap, B,
                                                                      context_parallel=True))
    _, cache = jax.jit(pre, in_shardings=psh)(params, {"tokens": jnp.asarray(toks)})
    cache = dict(cache, pos=jnp.asarray(S - 1, jnp.int32))
    jdec = jax.jit(dec, in_shardings=dsh, out_shardings=dout)
    out = []
    for i in range(CP_STEPS):
        logits, cache = jdec(params, cache, jnp.asarray(feed[i]))
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
def test_context_parallel_decode_over_the_mesh(ranks, world, shape):
    """``long_500k``'s split at a tiny size (gemma3's reduced config, a
    global and a local layer, batch 1, a cache of 256 rows split over every
    rank): the steps' decode logits equal one process's and the reference's
    jitted decode at one device, with the cache's sequence split over data ×
    model and no weight gathered."""
    want = _cp_reference(*CP_CASE)
    n = shape[0] * shape[1]
    for out in ranks[world].values():
        got = out[f"{shape}/serve_cp"]
        assert got["decode"] <= 1e-4 * got["scale"], (got["decode"], got["scale"])
        assert got["same_placements"] and got["storage_kept"] and got["gathers"] == 0
        k_pl = got["cache_placements"]["dense/k"]
        assert k_pl == "(Shard(dim=3), Shard(dim=3))", k_pl  # rows over data, then model
        assert len(got["decode_logits"]) == CP_STEPS
        for g, w in zip(got["decode_logits"], want):
            g = np.asarray(g, np.float32)
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (n, np.abs(g - w).max())


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
def test_ssm_context_parallel_decode_over_the_mesh(ranks, world, shape):
    """``long_500k``'s split for the ssm and hybrid families at a tiny size
    (reduced Mamba2 and Zamba2, batch 1, a cache of 32 rows, pos 19–21):
    the steps' prefill and decode logits equal one process's, and the decode
    logits the reference's jitted decode at one device; no weight gathered,
    each cache leaf's storage kept, in the reference's placements (the SSM
    state on its heads and the conv windows on their channels over
    ``model``, replicated over ``data``; Zamba2's shared K/V on its
    sequence over data × model)."""
    n = shape[0] * shape[1]
    for arch, seed in SSM_SERVE:
        want = _cp_reference(arch, seed, 1, 20, 32)
        for out in ranks[world].values():
            got = out[f"{shape}/serve_cp_{arch}"]
            assert got["prefill"] <= 1e-5 * got["scale"], (arch, got["prefill"], got["scale"])
            assert got["decode"] <= 1e-4 * got["scale"], (arch, got["decode"], got["scale"])
            assert got["same_placements"] and got["storage_kept"] and got["gathers"] == 0, arch
            assert got["cache_placements"] == _reference_cache_placements(arch, shape, 1, 32,
                                                                          True), arch
            assert len(got["decode_logits"]) == CP_STEPS
            for g, w in zip(got["decode_logits"], want):
                g = np.asarray(g, np.float32)
                assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (arch, n,
                                                                       np.abs(g - w).max())
