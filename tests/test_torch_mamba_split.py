"""A Mamba2 layer on a rank's blocks (``models/mamba.py`` under a
``tensor_parallel.Split``) over 2 and 4 gloo ranks against the whole layer.

Every rank draws the whole layer (reduced Mamba2: 8 SSM heads of 32
channels, ``G·N`` 16) and the inputs from numpy seeds and takes its blocks
of the weights by the partition tables (``partition.param_specs`` on a
``(1, world)`` mesh): ``w_z``/``w_x``/``w_dt``, the convolutions and the
norm on its channels and heads, ``w_B``/``w_C`` on ``G·N``, ``out_proj`` on
its rows, ``A_log``/``D``/``dt_bias`` whole. Its ``mamba_forward`` output
must equal the whole layer's, its final SSM state and conv tails the whole
layer's at its heads and channels; three ``mamba_decode`` steps from those
blocks of the cache give the whole steps' outputs and cache blocks.

Each gate must refuse a planted fault: the gated RMSNorm averaged over the
rank's block of ``d_inner`` only (its sum over ``model`` dropped), and B and
C left un-gathered (the rank's own columns repeated where the others'
belong). Tolerance: f32 sums in another order, ``TOL`` of each result's
largest entry (seen: 6.9e-7 of the prefill output, 5.5e-7 of a decode
step's, the state and tails exact); a planted fault moves the output by a
large share of it (seen: 0.03 to 0.55, against the gate's 0.01).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120
TOL = 1e-5
WORLDS = (2, 4)
FAULTS = ("none", "norm_on_block", "groups_not_gathered")

_RANKS = r"""
import json, os
import numpy as np, torch, torch.distributed as dist
rank, world = int(os.environ["RA_RANK"]), int(os.environ["RA_WORLD"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["RA_STORE"], world),
                        rank=rank, world_size=world)
try:
    from repro_torch.configs import get_config
    from repro_torch.distributed import partition
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, mamba
    from repro_torch.models.common import Initializer

    torch.manual_seed(0)
    cfg = get_config("mamba2_780m").reduced()
    sp = tp.make_split(make_mesh((1, world), ("data", "model"), "cpu"))
    B, S, STEPS = 2, 64, 3  # two chunks of 32
    whole = mamba.init_mamba(Initializer(torch.device("cpu"), torch.float32, 5), cfg)
    specs = partition.param_specs(build_model(cfg, device="meta").param_tree(), cfg,
                                  {"data": 1, "model": world})["layers"]["ssm"]

    def block(t, spec):  # this rank's block of a whole leaf (the stack's dim 0 dropped)
        for dim, ax in enumerate(spec[1:]):
            if ax == "model":
                t = t.chunk(world, dim)[rank]
        return t.clone()

    blocks = {k: block(v, specs[k]) for k, v in whole.items()}
    H, P = cfg.n_ssm_heads, cfg.ssm.headdim
    h0, nh = rank * H // world, H // world
    di, GN = cfg.d_inner, cfg.ssm.n_groups * cfg.ssm.d_state
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    steps_x = torch.from_numpy(rng.standard_normal((STEPS, B, 1, cfg.d_model)).astype(np.float32))

    def cols(t, n):  # this rank's block of the last dim of n
        return t[..., rank * n // world:(rank + 1) * n // world]

    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def checks():
        res = {"shapes": {k: list(v.shape) for k, v in blocks.items()}}
        out, (final, tails) = mamba.mamba_forward(whole, x, cfg, return_state=True)
        got, (gfinal, gtails) = mamba.mamba_forward(blocks, x, cfg, return_state=True, sp=sp)
        res["forward"] = err(got, out)
        res["state"] = err(gfinal, final[:, h0:h0 + nh])
        res["tails"] = max(err(gtails["x"], cols(tails["x"], di)),
                           err(gtails["B"], cols(tails["B"], GN)),
                           err(gtails["C"], cols(tails["C"], GN)))
        wc = {"ssm": final.clone(), "conv_x": tails["x"].clone(), "conv_B": tails["B"].clone(),
              "conv_C": tails["C"].clone()}
        bc = {"ssm": gfinal.clone(), "conv_x": gtails["x"].clone(),
              "conv_B": gtails["B"].clone(), "conv_C": gtails["C"].clone()}
        dec = cache = 0.0
        for xt in steps_x:
            want = mamba.mamba_decode(whole, xt, wc, cfg)
            dec = max(dec, err(mamba.mamba_decode(blocks, xt, bc, cfg, sp), want))
        cache = max(err(bc["ssm"], wc["ssm"][:, h0:h0 + nh]),
                    err(bc["conv_x"], cols(wc["conv_x"], di)),
                    err(bc["conv_B"], cols(wc["conv_B"], GN)),
                    err(bc["conv_C"], cols(wc["conv_C"], GN)))
        res["decode"], res["decode_cache"] = dec, cache
        return res

    out = {}
    for fault in json.loads(os.environ["RA_FAULTS"]):
        saved = {}
        if fault == "norm_on_block":  # each rank's mean over its own channels only
            saved["sum"] = tp.sum_over_model
            tp.sum_over_model = lambda t, sp: t * sp.model
        elif fault == "groups_not_gathered":  # the rank's own columns where all belong
            saved["groups"] = mamba._whole_groups
            mamba._whole_groups = lambda t, cfg, sp: torch.cat([t] * sp.model, dim=-1)
        try:
            out[fault] = checks()
        finally:
            if "sum" in saved:
                tp.sum_over_model = saved["sum"]
            if "groups" in saved:
                mamba._whole_groups = saved["groups"]
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
    tmp = tmp_path_factory.mktemp("mamba_split")
    return {world: _spawn(world, tmp) for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_mamba_layer_on_rank_blocks_matches_the_whole_layer(ranks, world):
    """Each rank's blocks are the partition tables' (8 heads and 16 ``G·N``
    columns over ``model``), and the layer on them gives the whole layer's
    output, and its heads' and channels' state and tails, in prefill and in
    three decode steps."""
    heads = 8 // world
    for rank, out in ranks[world].items():
        got = out["none"]
        assert got["shapes"]["w_dt"] == [128, heads] and got["shapes"]["w_B"] == [128, 16 // world]
        assert got["shapes"]["A_log"] == [8] and got["shapes"]["out_proj"] == [256 // world, 128]
        for key in ("forward", "state", "tails", "decode", "decode_cache"):
            assert got[key] <= TOL, (rank, key, got[key])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fault", FAULTS[1:])
def test_a_planted_fault_breaks_the_layer_gate(ranks, world, fault):
    """The norm averaged over a rank's block of ``d_inner``, or B and C left
    un-gathered: the output moves far past ``TOL`` in prefill and decode."""
    for rank, out in ranks[world].items():
        got = out[fault]
        assert got["forward"] > 0.01 and got["decode"] > 0.01, (rank, fault, got)


def test_blocks_that_do_not_hold_whole_heads_raise():
    """Where a rank's ``d_inner`` block does not hold whole heads, or its
    ``w_dt`` other heads than its ``w_x`` (the reference's ``_choose`` can
    leave ``w_dt`` whole beside a split ``w_x``), the layer raises naming
    the shapes and ROADMAP.md item 18."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import mamba

    cfg = get_config("mamba2_780m").reduced()  # 8 heads of 32 channels, d_model 128
    sp = tp.Split(2, 1)
    for w_x, w_dt in (((128, 128), (128, 8)), ((128, 48), (128, 2))):
        p = {"w_x": torch.zeros(w_x), "w_dt": torch.zeros(w_dt)}
        with pytest.raises(ValueError, match=r"ROADMAP.md item 18") as got:
            mamba._rank_heads(p, cfg, sp)
        assert str(w_x) in str(got.value) and str(w_dt) in str(got.value)
    assert mamba._rank_heads({"w_x": torch.zeros(128, 128), "w_dt": torch.zeros(128, 4)}, cfg,
                             sp) == (4, 4)
