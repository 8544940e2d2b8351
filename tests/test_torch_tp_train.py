"""The Megatron split's training half (``distributed/tensor_parallel.py``)
over 2 and 4 gloo ranks, each op against its definition on whole tensors,
and the reference's ``head_pad`` fault (ROADMAP.md §3 fault 11) in both
packages.

Every rank holds the whole inputs (numpy seeds) and takes its block of
them over ``model``; the gradients the ranks' autograd leaves in their
blocks, put together, must equal those of the same function on the whole
tensors:

* ``copy_to_model`` (Megatron's ``f``) before a column-parallel product:
  the input's gradient, which each rank holds a share of, summed;
* ``reduce_from_model`` (``g``) after a row-parallel one: the sum forward,
  the weight blocks' gradients;
* ``all_gather_for_replicated`` (a consumer every rank computes alike) and
  ``all_gather_for_split`` (a consumer split over ``model``, its backward a
  reduce-scatter): the weight blocks' gradients of each;
* ``reduce_scatter`` (a product split on its contraction whose consumer is
  split on another dim, as the experts' ``w_gate``/``w_up`` on ``d_model``
  feed ``w_down`` on the experts): the sum forward, the weight blocks'
  gradients;
* ``cross_entropy``: the loss, the accuracy and every logit's gradient equal
  ``models/common.py:cross_entropy_loss``'s on the whole logits, the
  reference's extra one-hot at the argmax included (fault 3), where the
  argmax lies on another rank than the label, and at a tie across ranks
  (the lowest global index wins, as ``argmax``).

Each gate must refuse a planted fault: ``f``'s backward all-reduce dropped,
the two all-gathers swapped, ``reduce_scatter``'s backward keeping this
rank's block only, the argmax's one-hot counted on every rank.
Tolerances: f32 sums in another order, ``TOL`` of each result's largest
entry; a planted fault moves a gradient by a share of it (half or more).
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.distributed import optimizer as jopt
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.distributed import optimizer as topt
from repro_torch.models import build_model
from repro_torch.models.convert import load_params, params_from_jax
from repro_torch.train.loop import make_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120
TOL = 1e-5
WORLDS = (2, 4)
FAULTS = ("none", "f_backward_dropped", "gathers_swapped", "reduce_scatter_backward_local",
          "argmax_on_every_rank")

_RANKS = r"""
import inspect, json, os
import numpy as np, torch, torch.distributed as dist
rank, world = int(os.environ["RA_RANK"]), int(os.environ["RA_WORLD"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["RA_STORE"], world),
                        rank=rank, world_size=world)
try:
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import cross_entropy_loss

    torch.manual_seed(0)
    sp = tp.make_split(make_mesh((1, world), ("data", "model"), "cpu"))
    B, S, d, N, V = 2, 3, 8, 4 * world, 8 * world

    def whole(*shape, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                                .astype(np.float32))

    def block(t, dim):
        return t.chunk(world, dim)[rank].clone()

    def put_together(t, dim):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim)

    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def checks():
        x, W, R = whole(B, S, d, seed=1), whole(d, N, seed=2), whole(B, S, N, seed=3)
        res = {}
        # f: a column-parallel product; the input's gradient summed over the ranks
        xs = x.clone().requires_grad_()
        (tp.copy_to_model(xs, sp) @ block(W, 1) * block(R, 2)).sum().backward()
        xw = x.clone().requires_grad_()
        ((xw @ W) * R).sum().backward()
        res["f"] = err(xs.grad, xw.grad)
        # g: a row-parallel product; the sum forward, each weight block's gradient
        Wr, xr = whole(N, d, seed=4), whole(B, S, N, seed=5)
        Rr = whole(B, S, d, seed=6)
        wb = block(Wr, 0).requires_grad_()
        y = tp.reduce_from_model(block(xr, 2) @ wb, sp)
        (y * Rr).sum().backward()
        ww = Wr.clone().requires_grad_()
        yw = xr @ ww
        (yw * Rr).sum().backward()
        res["g_forward"] = err(y.detach(), yw.detach())
        res["g"] = err(put_together(wb.grad, 0), ww.grad)
        # (a): the gathered output feeds a consumer every rank computes alike
        wa = block(W, 1).requires_grad_()
        (tp.all_gather_for_replicated(x @ wa, sp, 2) * R).sum().backward()
        ww = W.clone().requires_grad_()
        ((x @ ww) * R).sum().backward()
        res["gather_replicated"] = err(put_together(wa.grad, 1), ww.grad)
        # (b): each rank uses its own part of the gathered output (its own weights
        # R_r of it); the whole function sums the parts
        parts = [whole(B, S, N, seed=10 + r) for r in range(world)]
        wb = block(W, 1).requires_grad_()
        (tp.all_gather_for_split(x @ wb, sp, 2) * parts[rank]).sum().backward()
        ww = W.clone().requires_grad_()
        ((x @ ww) * sum(parts)).sum().backward()
        res["gather_split"] = err(put_together(wb.grad, 1), ww.grad)
        # reduce_scatter: partial products over the contraction's blocks, summed
        # to this rank's columns, which its consumer reads (its columns of R)
        Wc, xc = whole(N, d, seed=11), whole(B, S, N, seed=12)
        Rc = whole(B, S, d, seed=13)
        wc = block(Wc, 0).requires_grad_()
        yc = tp.reduce_scatter(block(xc, 2) @ wc, sp, 2)
        (yc * block(Rc, 2)).sum().backward()
        ww = Wc.clone().requires_grad_()
        yw = xc @ ww
        (yw * Rc).sum().backward()
        res["reduce_scatter_forward"] = err(put_together(yc.detach(), 2), yw.detach())
        res["reduce_scatter"] = err(put_together(wc.grad, 0), ww.grad)
        # the vocab-parallel cross-entropy against cross_entropy_loss on whole logits
        logits = whole(B, S, V, seed=7) * 3
        labels = torch.from_numpy(np.random.default_rng(8).integers(0, V, (B, S)))
        labels[0, 0] = int(torch.argmax(logits[0, 0]))  # a hit
        blk = V // world
        logits[1, 2, 0] = logits[1, 2, blk] = logits[1, 2].max() + 1  # a tie: rank 0's wins
        labels[1, 2] = 0
        mask = torch.ones(B, S)
        mask[1, 0] = 0
        lw = logits.clone().requires_grad_()
        loss_w, acc_w = cross_entropy_loss(lw, labels, mask)
        loss_w.backward()
        ls = block(logits, 2).requires_grad_()
        loss_s, acc_s = tp.cross_entropy(ls, labels, mask, V, sp, cross_entropy_loss)
        loss_s.backward()
        res["ce_loss"] = abs(float(loss_s) - float(loss_w)) / abs(float(loss_w))
        res["ce_acc"] = abs(float(acc_s) - float(acc_w))
        res["ce_acc_value"] = float(acc_s)
        res["ce_grad"] = err(put_together(ls.grad, 2), lw.grad)
        res["argmax_off_label_rank"] = int(
            (torch.argmax(logits, -1) // blk != labels // blk).sum())
        return res

    out = {}
    for fault in json.loads(os.environ["RA_FAULTS"]):
        saved = {}
        if fault == "f_backward_dropped":
            saved["_CopyToModel"] = tp._CopyToModel.backward
            tp._CopyToModel.backward = staticmethod(lambda ctx, g: (g, None))
        elif fault == "gathers_swapped":
            saved["gathers"] = (tp.all_gather_for_replicated, tp.all_gather_for_split)
            tp.all_gather_for_replicated, tp.all_gather_for_split = saved["gathers"][::-1]
        elif fault == "reduce_scatter_backward_local":
            # the gradient of this rank's block only, zeros for the others'
            saved["_ReduceScatter"] = tp._ReduceScatter.backward

            def local_only(ctx, g):
                parts = [torch.zeros_like(g) for _ in range(ctx.sp.model)]
                parts[ctx.sp.rank] = g
                return torch.cat(parts, ctx.dim), None, None
            tp._ReduceScatter.backward = staticmethod(local_only)
        elif fault == "argmax_on_every_rank":
            # the max as added back taken from every rank's own max: the same
            # forward, a one-hot gradient at each rank's argmax
            saved["cross_entropy"] = tp.cross_entropy
            src = inspect.getsource(tp.cross_entropy)
            line = "m = torch.where(own, top, 0.0)"
            assert line in src
            src = src.replace(line, "m = top - top.detach() + "
                                    "torch.where(own, top, 0.0).detach()")
            scope = dict(vars(tp))
            exec(src, scope)
            tp.cross_entropy = scope["cross_entropy"]
        try:
            out[fault] = checks()
        finally:
            if "_CopyToModel" in saved:
                tp._CopyToModel.backward = staticmethod(saved["_CopyToModel"])
            if "gathers" in saved:
                tp.all_gather_for_replicated, tp.all_gather_for_split = saved["gathers"]
            if "_ReduceScatter" in saved:
                tp._ReduceScatter.backward = staticmethod(saved["_ReduceScatter"])
            if "cross_entropy" in saved:
                tp.cross_entropy = saved["cross_entropy"]
    print(json.dumps({"rank": rank, "out": out}))
finally:
    dist.destroy_process_group()
"""


def _spawn(world, tmp):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")])),
        RA_STORE=str(tmp / f"store{world}"), RA_WORLD=str(world), OMP_NUM_THREADS="1",
        RA_FAULTS=json.dumps(FAULTS))
    procs = [subprocess.Popen([sys.executable, "-c", _RANKS], env=dict(env, RA_RANK=str(r)),
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
    """{world: {rank: {fault: readings}}} of the 2-rank and the 4-rank sets."""
    tmp = tmp_path_factory.mktemp("tp_train")
    return {world: _spawn(world, tmp) for world in WORLDS}


#: the gate each planted fault must break
BROKEN_BY = {"f_backward_dropped": ("f",), "gathers_swapped": ("gather_replicated",
                                                               "gather_split"),
             "reduce_scatter_backward_local": ("reduce_scatter",),
             "argmax_on_every_rank": ("ce_grad",)}


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_and_cross_entropy_match_whole_tensors(ranks, world):
    """Every op's forward and gradient on each rank equal the whole
    function's (the cross-entropy's one-hot at the argmax, once, and the
    accuracy by the lowest global index at a tie)."""
    for rank, out in ranks[world].items():
        got = out["none"]
        for key in ("f", "g_forward", "g", "gather_replicated", "gather_split",
                    "reduce_scatter_forward", "reduce_scatter", "ce_loss", "ce_grad"):
            assert got[key] <= TOL, (rank, key, got[key])
        assert got["ce_acc"] == 0.0 and got["ce_acc_value"] > 0, (rank, got)
        assert got["argmax_off_label_rank"] > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fault", FAULTS[1:])
def test_each_planted_fault_breaks_its_gate(ranks, world, fault):
    """A dropped all-reduce in ``f``'s backward, the two all-gathers swapped
    (a gradient ``model`` times too large, or one rank's share), the
    reduce-scatter's backward keeping one rank's block, the argmax's one-hot
    on every rank: each moves its gradient far past ``TOL``, while the
    forward (loss, accuracy) stays the same."""
    for rank, out in ranks[world].items():
        got = out[fault]
        for key in BROKEN_BY[fault]:
            assert got[key] > 0.1, (rank, fault, key, got[key])
        assert got["ce_loss"] <= TOL and got["ce_acc"] == 0.0


# ------------------------------------------------------- fault 11: head_pad
LR = 1e-3


@functools.lru_cache(maxsize=None)
def _padded_pair():
    """Reduced qwen (4 heads + 8 zero-padded, qkv bias) in both packages from
    the same weights (the port's init, the attention tempered as
    ``tests/test_torch_steps.py:_temper``), and a batch."""
    cfg = get_config("qwen2_5_14b").reduced()
    port = build_model(cfg, device="cpu", seed=3)
    H, KV, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    with torch.no_grad():
        for name, f in (("wq", H / d), ("wk", KV / d), ("wv", KV / d), ("wo", 1 / H)):
            getattr(port.dense_layers.attn, name).mul_(f ** 0.5)
    params = _numpy(port.param_tree())
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (2, 32)).astype(np.int32)
    return cfg, params, toks


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def test_padded_heads_take_a_gradient_in_wo_in_both_packages():
    """ROADMAP.md §3 fault 11: the reference's ``init_gqa`` says the padded
    heads take exactly 0 gradient (``src/repro/models/attention.py:71-75``).
    That holds for ``wq`` and ``bq``, not for ``wo``: a padded head's ``q`` is
    zero, so its output is the causal mean of ``v`` and ``∂wo[H:]`` = oᵀ·dy.
    Both packages give the same gradient; after one AdamW step the padded
    rows of ``wo`` are nonzero, and the port's equal the reference's."""
    cfg, params, toks = _padded_pair()
    H = cfg.n_heads
    assert cfg.head_pad and H + cfg.head_pad > H
    jmodel = jax_build(jax_config("qwen2_5_14b").reduced())
    batch = {"tokens": jnp.asarray(toks)}
    jgrads = jax.jit(jax.grad(lambda p: jmodel.train_loss(p, batch)[0]))(params)
    port = build_model(cfg, device="cpu")
    load_params(port, params_from_jax(params))
    port.requires_grad_(True)
    loss, _ = port.train_loss({"tokens": torch.from_numpy(toks)})
    loss.backward()
    attn = port.dense_layers.attn
    jattn = jgrads["dense_layers"]["attn"]
    for name, got, want in (("wo", attn.wo.grad[:, H:], jattn["wo"][:, H:]),
                            ("wq", attn.wq.grad[:, :, H:], jattn["wq"][:, :, H:]),
                            ("bq", attn.bq.grad[:, H:], jattn["bq"][:, H:])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * np.abs(np.asarray(jattn[name])).max(),
                                   err_msg=name)
        if name == "wo":
            assert np.abs(want).max() > 0.1 * np.abs(np.asarray(jattn["wo"][:, :H])).max()
        else:
            assert not want.any() and not got.any(), name  # exact zeros in both

    kw = dict(lr=LR, warmup_steps=0, total_steps=10)
    jp, _, _ = jopt.apply_updates(params, jgrads, jopt.init_state(params, jopt.AdamWConfig(**kw)),
                                  jopt.AdamWConfig(**kw))
    model = build_model(cfg, device="cpu")
    load_params(model, params_from_jax(params))
    model.requires_grad_(True)
    tp_ = model.param_tree()
    make_step(model, topt.AdamWConfig(**kw))(tp_, topt.init_state(tp_, topt.AdamWConfig(**kw)),
                                            {"tokens": torch.from_numpy(toks)})
    got = model.dense_layers.attn.wo.detach()[:, H:].numpy()
    want = np.asarray(jp["dense_layers"]["attn"]["wo"])[:, H:]
    assert np.abs(got).max() > 0.5 * LR and np.abs(want).max() > 0.5 * LR  # moved off zero
    # a first step moves an entry by ~lr·sign(g): a gradient within rounding of zero
    # may step the other way (2·lr), a few entries at most
    np.testing.assert_allclose(got, want, rtol=0, atol=2.2 * LR)
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-6)
    assert off.sum() <= 2e-3 * off.size, off.sum()
    assert not model.dense_layers.attn.wq.detach()[:, :, H:].any()
