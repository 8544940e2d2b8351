"""The port's expert-parallel MoE (``distributed/moe_ep.py``) against the JAX
package's ``_ep_block``, which runs here on one CPU device under
``jax.vmap(..., axis_name="model")``: its ``all_to_all``s and ``pmean``
evaluate across the mapped axis, the expert weights reshaped to (n, E/n,
...). One shard runs in this process; 2 and 4 shards run as gloo ranks
(subprocesses meeting through a ``FileStore``), spawned once for the file
over a (2, 2) mesh (two model groups of 2) and a (1, 4) one."""

import dataclasses
import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _moe_ep_case import AUX_WEIGHT, CAPACITY, TL, cut, ffn_params
from _moe_ep_case import inputs as _inputs
from repro.configs import get_config as jax_config
from repro.distributed.moe_ep import _ep_block as jax_ep_block
from repro_torch.configs import get_config
from repro_torch.distributed.moe_ep import _ep_block, _positions_by_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for the file: the blocks are tiny, and the suite's
    other workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(capacity):
    return (cut(jax_config("deepseek_v3_671b").reduced(), capacity),
            cut(get_config("deepseek_v3_671b").reduced(), capacity))


def _jax_ep(n, inp, jcfg):
    """The vmapped reference: (y (n, TL, d), aux (n,), grads of sum(y·ct) +
    AUX_WEIGHT·sum(aux) by input)."""
    E = jcfg.moe.n_experts
    block = jax.vmap(partial(jax_ep_block, cfg=jcfg, n_shards=n, axis="model"),
                     in_axes=(0, None, 0, 0, 0), axis_name="model")

    def run(x, router, wg, wu, wd):
        sh = lambda w: w.reshape(n, E // n, *w.shape[1:])  # noqa: E731
        return block(x, router, sh(wg), sh(wu), sh(wd))

    args = [jnp.asarray(inp[k]) for k in ("x", "router", "w_gate", "w_up", "w_down")]
    y, aux = jax.jit(run)(*args)

    def loss(*a):
        yy, ax = run(*a)
        return jnp.sum(yy * inp["ct"]) + AUX_WEIGHT * jnp.sum(ax)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    names = ("x", "router", "w_gate", "w_up", "w_down")
    return np.asarray(y), np.asarray(aux), {k: np.asarray(g) for k, g in zip(names, grads)}


def test_positions_by_key_are_stable():
    keys = torch.tensor([2, 0, 2, 1, 0, 2, 3])
    assert _positions_by_key(keys, 4).tolist() == [0, 0, 1, 0, 1, 2, 0]


@pytest.mark.parametrize("drops", sorted(CAPACITY))
def test_one_shard_matches_the_vmapped_reference(drops):
    """n_shards 1: no collective; outputs, aux and every gradient."""
    jcfg, tcfg = _cfgs(CAPACITY[drops])
    m = tcfg.moe
    inp = _inputs(1, 3, tcfg.d_model, m.n_experts, m.d_ff_expert)
    y_want, aux_want, g_want = _jax_ep(1, inp, jcfg)
    t = {k: torch.tensor(v, requires_grad=True) for k, v in inp.items() if k != "ct"}
    y, aux = _ep_block(t["x"][0], t["router"], t["w_gate"], t["w_up"], t["w_down"], cfg=tcfg,
                       n_shards=1)
    np.testing.assert_allclose(y.detach().numpy(), y_want[0], **TOL)
    np.testing.assert_allclose(float(aux.detach()), aux_want[0], **TOL)
    (torch.sum(y * torch.from_numpy(inp["ct"][0])) + AUX_WEIGHT * aux).backward()
    for k, g in g_want.items():
        np.testing.assert_allclose(t[k].grad.numpy(), g, rtol=1e-5, atol=1e-5 * np.abs(g).max(),
                                   err_msg=k)


_RANKS = r"""
import json, os, sys, dataclasses
import numpy as np, torch, torch.distributed as dist
sys.path.insert(0, os.environ["RA_TESTS"])
rank, world = int(os.environ["RA_RANK"]), int(os.environ["RA_WORLD"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["RA_STORE"], world),
                        rank=rank, world_size=world)
try:
    from _moe_ep_case import AUX_WEIGHT, CAPACITY, cut, ffn_params, inputs
    from repro_torch.configs import get_config
    from repro_torch.distributed.moe_ep import _ep_block, moe_ffn_ep
    from repro_torch.launch.mesh import make_mesh

    base = get_config("deepseek_v3_671b").reduced()

    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        n, r = shape[1], mesh.get_local_rank("model")
        group = mesh.get_group("model")
        row = mesh.get_local_rank("data")
        for drops, cap in sorted(CAPACITY.items()):
            cfg = cut(base, cap)
            m = cfg.moe
            inp = inputs(n, 10 * n + row, cfg.d_model, m.n_experts, m.d_ff_expert)
            e = m.n_experts // n
            t = {"x": torch.tensor(inp["x"][r], requires_grad=True),
                 "router": torch.tensor(inp["router"], requires_grad=True)}
            for k in ("w_gate", "w_up", "w_down"):
                t[k] = torch.tensor(inp[k][r * e:(r + 1) * e], requires_grad=True)
            y, aux = _ep_block(t["x"], t["router"], t["w_gate"], t["w_up"], t["w_down"],
                               cfg=cfg, n_shards=n, group=group)
            (torch.sum(y * torch.from_numpy(inp["ct"][r])) + AUX_WEIGHT * aux).backward()
            rg = t["router"].grad.clone()
            dist.all_reduce(rg, group=group)
            out[f"{shape}/{drops}"] = {
                "y": y.detach().tolist(), "aux": float(aux),
                "grads": {k: (rg if k == "router" else v.grad).tolist() for k, v in t.items()}}
        # the FFN as a model calls it: this rank's batch block, full plain experts,
        # two dispatch chunks and the shared expert
        cfg = cut(base, CAPACITY["no_drops"])
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, dispatch_chunks=2))
        p, rng = ffn_params(cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert)
        p = {k: torch.from_numpy(v) for k, v in p.items()}
        x = torch.tensor(rng.standard_normal((world * 2, 6, cfg.d_model)), dtype=torch.float32)
        y, aux = moe_ffn_ep(p, x[2 * rank:2 * rank + 2], cfg, mesh)
        out[f"{shape}/ffn"] = {"y": y.tolist(), "aux": float(aux)}
    print(json.dumps({"rank": rank, "out": out}))
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four gloo ranks' results, keyed by mesh shape and case."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")])),
        RA_STORE=str(tmp / "store"), RA_WORLD="4", RA_TESTS=os.path.join(REPO, "tests"),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANKS], env=dict(env, RA_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
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


def _groups(shape):
    """The ranks of each model group, in model order: (row, [ranks])."""
    if shape == (2, 2):
        return [(0, [0, 1]), (1, [2, 3])]
    return [(0, [0, 1, 2, 3])]


@pytest.mark.parametrize("drops", sorted(CAPACITY))
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2_shards", "4_shards"])
def test_gloo_shards_match_the_vmapped_reference(ranks, shape, drops):
    """n_shards 2 and 4 over gloo: each rank's outputs, the aux (its pmean)
    and the gradients (the router's summed over the shards, as ``jax.grad``
    of the vmapped block sums them) equal the reference's."""
    jcfg, tcfg = _cfgs(CAPACITY[drops])
    m = tcfg.moe
    n = shape[1]
    for row, members in _groups(shape):
        inp = _inputs(n, 10 * n + row, tcfg.d_model, m.n_experts, m.d_ff_expert)
        y_want, aux_want, g_want = _jax_ep(n, inp, jcfg)
        e = m.n_experts // n
        for r, rank in enumerate(members):
            got = ranks[rank][f"{shape}/{drops}"]
            np.testing.assert_allclose(np.array(got["y"]), y_want[r], **TOL)
            np.testing.assert_allclose(got["aux"], aux_want[r], **TOL)
            want = {"x": g_want["x"][r], "router": g_want["router"]}
            for k in ("w_gate", "w_up", "w_down"):
                want[k] = g_want[k][r * e:(r + 1) * e]
            for k, g in want.items():
                np.testing.assert_allclose(np.array(got["grads"][k]), g, rtol=1e-5,
                                           atol=1e-5 * np.abs(g).max(), err_msg=k)
    if drops == "drops":  # the case drops routes at both stages' capacity
        assert CAPACITY[drops] * TL * m.top_k / n < TL * m.top_k


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2_ranks", "4_ranks"])
def test_moe_ffn_ep_over_gloo_equals_one_process(ranks, shape):
    """``moe_ffn_ep`` on each rank's batch block (two dispatch chunks, the
    shared expert) equals the same computation in one process: each chunk
    through the vmapped reference block over the model group's blocks."""
    jcfg, tcfg = _cfgs(CAPACITY["no_drops"])
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, dispatch_chunks=2))
    d, E = tcfg.d_model, tcfg.moe.n_experts
    p, rng = ffn_params(d, E, tcfg.moe.d_ff_expert)
    x = rng.standard_normal((8, 6, d)).astype(np.float32)
    n = shape[1]
    block = jax.jit(jax.vmap(partial(jax_ep_block, cfg=jcfg, n_shards=n, axis="model"),
                             in_axes=(0, None, 0, 0, 0), axis_name="model"))
    sh = lambda w: jnp.asarray(w).reshape(n, E // n, *w.shape[1:])  # noqa: E731
    silu = jax.nn.silu
    for _, members in _groups(shape):
        xs = np.stack([x[2 * r:2 * r + 2].reshape(12, d) for r in members])  # (n, Tl, d)
        ys, auxes = [], []
        for c in range(2):  # the block's chunk loop: each chunk across the group at once
            y, aux = block(jnp.asarray(xs[:, 6 * c:6 * c + 6]), jnp.asarray(p["router"]),
                           sh(p["w_gate"]), sh(p["w_up"]), sh(p["w_down"]))
            ys.append(np.asarray(y))
            auxes.append(np.asarray(aux))
        y = np.concatenate(ys, axis=1)
        shared = (np.asarray(silu(xs @ p["shared_gate"])) * (xs @ p["shared_up"])) \
            @ p["shared_down"]
        y = y + shared
        for i, rank in enumerate(members):
            got = ranks[rank][f"{shape}/ffn"]
            np.testing.assert_allclose(np.array(got["y"]).reshape(12, d), y[i], **TOL)
            np.testing.assert_allclose(got["aux"], np.mean([a[i] for a in auxes]), **TOL)
