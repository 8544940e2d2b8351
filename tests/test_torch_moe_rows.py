"""The port's MoE dispatch over the row blocks of a global batch against one
process's dispatch of the whole batch and the JAX reference's.

Under ``jit`` the reference's ``moe_ffn`` (``src/repro/models/moe.py``)
routes the global batch: its dispatch chunks are the global tokens', each
with the capacity ``C`` of a global chunk, and its aux loss is the mean
over every chunk of a product of two means over the chunk's tokens. Here
2 and 4 gloo ranks (subprocesses meeting through a ``FileStore``) each hold
one block of the rows of one global ``x`` (B 8, S 6: 48 tokens) and run
``moe_ffn`` under a split whose rows are split over ``data``
(``tensor_parallel.make_split(row_axes=...)``). Their outputs, concatenated,
the aux loss, the dropped routes and the gradients of ``x``, the router and
the experts (the ranks' losses ``sum(y·g) + aux / n``, their weight
gradients summed over the ranks, as the steps sum them) equal one process's
``moe_ffn`` on the whole ``x`` and the reference's, within ``TOL`` of each
tensor's largest entry (f32), the drops exactly. The configs are the
reduced kimi-k2 and deepseek-v3 (4 experts, top-2, a shared expert) at
their own capacity factor 1.25, with the router leaning to expert 0 so that
routes drop, over 1, 2, 3 and 4 dispatch chunks: chunks that each block
holds whole (2 and 4 over 2 blocks, 4 over 4), and chunks that span blocks
(1, 3, and 2 over 4)."""

import dataclasses
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
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240
TOL = 1e-6  # f32: of each tensor's largest |entry|
ARCHS = ["kimi_k2_1t", "deepseek_v3_671b"]
CHUNKS = [1, 2, 3, 4]
WORLDS = [2, 4]
B, S = 8, 6
LEAVES = ("router", "w_gate", "w_up", "w_down", "shared_gate", "shared_up", "shared_down")


def _config(arch, chunks, jax_side=False):
    cfg = (jax_config if jax_side else get_config)(arch).reduced()
    return cfg.with_(moe=dataclasses.replace(cfg.moe, dispatch_chunks=chunks))


def _inputs(arch):
    """(params, x (B, S, d), the loss's weights g (B, S, d)) in numpy f32,
    from a seed: the reference's init scales, the router leaning to expert
    0 (x carries a constant offset that its column reads), so that expert 0
    overflows its capacity."""
    cfg = get_config(arch).reduced()
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(ARCHS.index(arch))
    E, ffe, ffs = m.n_experts, m.d_ff_expert, m.d_ff_expert * m.n_shared

    def fanin(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    router = rng.standard_normal((d, E)).astype(np.float32) * 0.1
    router[:, 0] += 0.02
    p = {"router": router, "w_gate": fanin(E, d, ffe), "w_up": fanin(E, d, ffe),
         "w_down": fanin(E, ffe, d), "shared_gate": fanin(d, ffs), "shared_up": fanin(d, ffs),
         "shared_down": fanin(ffs, d)}
    x = (rng.standard_normal((B, S, d)) + 0.5).astype(np.float32)
    g = rng.standard_normal((B, S, d)).astype(np.float32)
    return p, x, g


_RANKS = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
rank, world = int(os.environ["RA_RANK"]), int(os.environ["RA_WORLD"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["RA_STORE"], world),
                        rank=rank, world_size=world)
try:
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    mesh = make_mesh((world, 1), ("data", "model"), "cpu")
    sp = tp.make_split(mesh, row_axes=("data",))
    keeps = []
    dispatch = moe._dispatch

    def recording(*a, **k):
        y, keep = dispatch(*a, **k)
        keeps.append(keep)
        return y, keep
    moe._dispatch = recording
    for case in json.loads(os.environ["RA_CASES"]):
        arch, chunks = case
        cfg = _config(arch, chunks)
        p, x, g = _inputs(arch)
        n = x.shape[0] // world
        p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
        xr = torch.from_numpy(x[rank * n:(rank + 1) * n]).requires_grad_(True)
        gr = torch.from_numpy(g[rank * n:(rank + 1) * n])
        keeps.clear()
        y, aux = moe.moe_ffn(p, xr, cfg, sp)
        ((y * gr).sum() + aux / world).backward()
        grads = {k: v.grad for k, v in p.items()}
        for t in grads.values():  # the ranks' shares of the weights' gradients, summed
            dist.all_reduce(t)
        torch.save({"y": y.detach(), "aux": aux.detach(), "x_grad": xr.grad,
                    "grads": grads, "keep": torch.cat(keeps)},
                   os.path.join(os.environ["RA_OUT"], f"{arch}_{chunks}_{world}_{rank}.pt"))
    print(json.dumps({"rank": rank}))
finally:
    dist.destroy_process_group()
"""


def _spawn(world, tmp):
    import inspect

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")])),
        RA_STORE=str(tmp / f"store{world}"), RA_WORLD=str(world), OMP_NUM_THREADS="1",
        RA_OUT=str(tmp), RA_CASES=json.dumps([[a, c] for a in ARCHS for c in CHUNKS]))
    script = ("import dataclasses\nfrom repro_torch.configs import get_config\n"
              f"ARCHS, B, S = {ARCHS!r}, {B}, {S}\n" + inspect.getsource(_config) +
              inspect.getsource(_inputs) + _RANKS)
    procs = [subprocess.Popen([sys.executable, "-c", script], env=dict(env, RA_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The directory holding each rank's results of every case."""
    tmp = tmp_path_factory.mktemp("moe_rows")
    for world in WORLDS:
        _spawn(world, tmp)
    return tmp


@functools.lru_cache(maxsize=None)
def _one_process(arch, chunks):
    """The port's ``moe_ffn`` on the whole ``x`` in this process: y, aux,
    the gradients and the routes kept, in token-major order."""
    cfg = _config(arch, chunks)
    p, x, g = _inputs(arch)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    keeps = []
    dispatch = tmoe._dispatch

    def recording(*a, **k):
        y, keep = dispatch(*a, **k)
        keeps.append(keep)
        return y, keep
    tmoe._dispatch = recording
    try:
        y, aux = tmoe.moe_ffn(p, xt, cfg)
    finally:
        tmoe._dispatch = dispatch
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    return {"y": y.detach().numpy(), "aux": float(aux.detach()), "x_grad": xt.grad.numpy(),
            "grads": {k: v.grad.numpy() for k, v in p.items()},
            "keep": torch.cat(keeps).numpy()}


@functools.lru_cache(maxsize=None)
def _reference(arch, chunks):
    """The reference's ``moe_ffn`` on the whole ``x`` (JAX's CPU backend):
    y, aux, the gradients, and the routes its capacity keeps (each chunk's
    routes by the reference's own ``route``, queued token-major)."""
    cfg = _config(arch, chunks, jax_side=True)
    m = cfg.moe
    p, x, g = _inputs(arch)

    def loss(p, x):
        y, aux = jmoe.moe_ffn(p, x, cfg)
        return jnp.sum(y * g) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    T = B * S
    nc = m.dispatch_chunks if T % m.dispatch_chunks == 0 else 1
    Tc = T // nc
    C = max(1, int(np.ceil(Tc * m.top_k / m.n_experts * m.capacity_factor)))
    keep = []
    for xc in x.reshape(nc, Tc, -1):
        idx = np.asarray(jmoe.route(p, jnp.asarray(xc), cfg)[0]).reshape(-1)
        seen = np.zeros(m.n_experts, np.int64)
        for e in idx:
            keep.append(seen[e] < C)
            seen[e] += 1
    return {"y": np.asarray(y), "aux": float(aux), "x_grad": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gp.items()}, "keep": np.asarray(keep)}


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


def _over_ranks(tmp, arch, chunks, world):
    parts = [torch.load(tmp / f"{arch}_{chunks}_{world}_{r}.pt") for r in range(world)]
    return {"y": torch.cat([q["y"] for q in parts]).numpy(), "aux": [float(q["aux"]) for q in parts],
            "x_grad": torch.cat([q["x_grad"] for q in parts]).numpy(),
            "grads": [{k: v.numpy() for k, v in q["grads"].items()} for q in parts],
            "keep": torch.cat([q["keep"] for q in parts]).numpy()}


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_matches_the_reference(arch, chunks):
    """The port's dispatch of the whole batch in one process is the
    reference's: outputs, aux loss, drops and gradients."""
    want, got = _reference(arch, chunks), _one_process(arch, chunks)
    assert not want["keep"].all(), "no route dropped: the case shows nothing"
    np.testing.assert_array_equal(got["keep"], want["keep"])
    _close(got["y"], want["y"], "y")
    _close(got["aux"], want["aux"], "aux")
    _close(got["x_grad"], want["x_grad"], "x_grad")
    for k in LEAVES:
        _close(got["grads"][k], want["grads"][k], k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_row_blocks_route_the_global_batch(ranks, arch, chunks, world):
    """Over ``world`` row blocks, every rank's aux loss, the outputs, the
    drops and the gradients (weights' summed over the ranks) are one
    process's on the whole batch and the reference's."""
    got = _over_ranks(ranks, arch, chunks, world)
    for want in (_one_process(arch, chunks), _reference(arch, chunks)):
        np.testing.assert_array_equal(got["keep"], want["keep"])
        _close(got["y"], want["y"], "y")
        for aux in got["aux"]:
            _close(aux, want["aux"], "aux")
        _close(got["x_grad"], want["x_grad"], "x_grad")
        for grads in got["grads"]:
            for k in LEAVES:
                _close(grads[k], want["grads"][k], k)
