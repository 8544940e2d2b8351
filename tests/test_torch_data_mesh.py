"""The port's data mesh (``repro_torch.distributed.data_mesh``, DESIGN.md §15)
held to the JAX package's: a mirror of every case of ``tests/test_data_mesh.py``
with each result compared bit for bit against the reference's on the same
inputs. Shard ownership, plans, repartitions and the loader's batches come
from the copied numpy schedule and must equal the reference's; the global
assembly is the port's own (``DTensor`` over a ``DeviceMesh``), held on the
CPU to the reference's batches in a world of one and, over gloo, in worlds
of 4 ranks (the simulated hosts) and 2 ranks (a sharded cold start).

Ranks run as subprocesses that meet through a ``FileStore`` under the
test's ``tmp_path`` (never a fixed port: the suite runs in parallel
workers); each has its own timeout, and every test destroys the process
group it made."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st
from torch.distributed.tensor import DTensor

import repro.data as jdata
import repro.distributed.data_mesh as jmesh
from repro.core import racat as jracat
from repro.data.dataset import DatasetBuilder
from repro_torch.core import racat as tracat
from repro_torch.core.spec import RawArrayError
from repro_torch.data import DataLoader, DeviceLoader, LoaderState, RaDataset
from repro_torch.distributed import data_mesh as tmesh
from repro_torch.distributed.data_mesh import (
    DataMesh,
    EpochPlan,
    aggregate_stats,
    owners_table,
    shard_owners,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL, SHARD_ROWS, W = 320, 16, 2  # 20 shards; row i holds [i, i]
RANK_TIMEOUT = 240  # seconds a gloo rank subprocess may take


@pytest.fixture(scope="module")
def rid_root(tmp_path_factory):
    """Written by the JAX package's DatasetBuilder."""
    root = str(tmp_path_factory.mktemp("tmesh") / "ds")
    b = DatasetBuilder(root, {"rid": ((W,), np.int64)}, shard_rows=SHARD_ROWS)
    ids = np.arange(TOTAL, dtype=np.int64)
    b.append(rid=np.stack([ids] * W, axis=1))
    b.finish()
    return root


@pytest.fixture(scope="module")
def quant_root(tmp_path_factory):
    """u8-quantized images and int labels, by the JAX package's DatasetBuilder."""
    root = str(tmp_path_factory.mktemp("tmesh") / "imgs")
    rng = np.random.default_rng(0)
    b = jdata.DatasetBuilder(
        root, {"image": ((4, 4, 3), "float32"), "label": ((), "int32")},
        shard_rows=24, quantize={"image": "u8"})
    b.append(image=rng.random((192, 4, 4, 3)).astype(np.float32),
             label=rng.integers(0, 10, 192).astype(np.int32))
    b.finish()
    return root


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """A world-of-one global path starts a process group in this process:
    each test leaves none behind."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _drain(dl, steps):
    out = [np.asarray(next(dl)["rid"])[:, 0].copy() for _ in range(steps)]
    return np.concatenate(out) if out else np.empty(0, np.int64)


def _pair(root, B, seed, host, hosts):
    """The port's and the reference's mesh loaders for one host."""
    return (DataLoader(RaDataset(root), B, seed=seed, mesh=DataMesh(host, hosts)),
            jdata.DataLoader(jdata.RaDataset(root), B, seed=seed,
                             mesh=jmesh.DataMesh(host, hosts)))


def _same_batch(got, want):
    assert got["_state"].__dict__ == want["_state"].__dict__
    for f in want:
        if f != "_state":
            assert np.asarray(got[f]).dtype == want[f].dtype, f
            assert np.array_equal(np.asarray(got[f]), want[f]), f


# ---- ownership ------------------------------------------------------------


def test_ownership_deterministic_and_minimal_movement():
    hosts4, hosts5 = ["h0", "h1", "h2", "h3"], ["h0", "h1", "h2", "h3", "h4"]
    before = shard_owners(128, hosts4, epoch=1)
    assert before == shard_owners(128, hosts4, epoch=1)
    assert before == jmesh.shard_owners(128, hosts4, epoch=1)
    after = shard_owners(128, hosts5, epoch=1)
    assert after == jmesh.shard_owners(128, hosts5, epoch=1)
    moved = [(x, y) for x, y in zip(before, after) if x != y]
    assert 0 < len(moved) <= 64
    assert all(y == "h4" for _, y in moved)


def test_ownership_epoch_redeal(monkeypatch):
    hosts = ["a", "b", "c"]
    for epoch in (0, 1):
        assert shard_owners(64, hosts, epoch=epoch) == jmesh.shard_owners(64, hosts, epoch=epoch)
    assert shard_owners(64, hosts, epoch=0) != shard_owners(64, hosts, epoch=1)
    monkeypatch.setenv("RA_MESH_EPOCH_REOWN", "0")
    assert shard_owners(64, hosts, epoch=0) == shard_owners(64, hosts, epoch=1)
    assert shard_owners(64, hosts, epoch=1) == jmesh.shard_owners(64, hosts, epoch=1)


# ---- plan invariants (pure, no dataset) -----------------------------------


@settings(max_examples=25, deadline=None)
@given(nhosts=st.integers(1, 6), seed=st.integers(0, 5), epoch=st.integers(0, 3))
def test_plan_streams_cover_exactly_once(nhosts, seed, epoch):
    shard_rows = [17, 3, 64, 1, 29, 16, 16, 40, 8, 11]
    hosts = [f"h{i}" for i in range(nhosts)]
    kw = dict(seed=seed, epoch=epoch, segments=[(0, hosts)], batch_size=4)
    plan, ref = EpochPlan(shard_rows, **kw), jmesh.EpochPlan(shard_rows, **kw)
    for h in hosts:
        assert np.array_equal(plan.host_stream(h), ref.host_stream(h))
    allr = np.concatenate([plan.host_stream(h) for h in hosts])
    assert len(np.unique(allr)) == len(allr) == sum(shard_rows)
    assert plan.steps() == ref.steps()


def test_global_shuffle_host_agnostic():
    shard_rows = [16] * 12
    hosts = ["a", "b", "c"]
    plans = [DataMesh(h, hosts).plan(shard_rows, seed=9, epoch=2, batch_size=4)
             for h in hosts]
    ref = jmesh.DataMesh("a", hosts).plan(shard_rows, seed=9, epoch=2, batch_size=4)
    assert {p.steps() for p in plans} == {ref.steps()}
    for h in hosts:
        for p in plans:
            assert np.array_equal(p.host_order(h), ref.host_order(h))


def test_shuffle_varies_by_epoch():
    mesh, ref = DataMesh("a", ["a", "b"]), jmesh.DataMesh("a", ["a", "b"])
    p0 = mesh.plan([16] * 12, seed=1, epoch=0, batch_size=4)
    p1 = mesh.plan([16] * 12, seed=1, epoch=1, batch_size=4)
    n = 4 * min(p0.steps(), p1.steps())
    assert not np.array_equal(p0.host_order("a")[:n], p1.host_order("a")[:n])
    for epoch, p in ((0, p0), (1, p1)):
        r = ref.plan([16] * 12, seed=1, epoch=epoch, batch_size=4)
        assert np.array_equal(p.host_order("a"), r.host_order("a"))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 5), n0=st.integers(1, 4), n1=st.integers(1, 5),
       t_frac=st.floats(0.0, 1.0))
def test_repartition_plan_preserves_exactly_once(seed, n0, n1, t_frac):
    shard_rows = [16] * 14
    B = 4
    start = [f"h{i}" for i in range(n0)]
    p0 = EpochPlan(shard_rows, seed=seed, epoch=0, segments=[(0, start)], batch_size=B)
    t = int(round(t_frac * p0.steps()))
    new = [f"h{i}" for i in range(n1)]
    kw = dict(seed=seed, epoch=0, segments=[(0, start), (t, new)], batch_size=B)
    plan, ref = EpochPlan(shard_rows, **kw), jmesh.EpochPlan(shard_rows, **kw)
    union = sorted(set(start) | set(new))
    orders = [plan.host_order(h) for h in union]
    for h, o in zip(union, orders):
        assert np.array_equal(o, ref.host_order(h))
    allr = np.concatenate([o[o >= 0] for o in orders])
    assert len(np.unique(allr)) == len(allr)
    assert len(allr) == t * B * len(start) + (plan.steps() - t) * B * len(new)
    assert plan.dropped_rows() == ref.dropped_rows() == sum(shard_rows) - len(allr)


# ---- loader end-to-end ----------------------------------------------------


def test_mesh_epoch_exactly_once_owned_only_byte_exact(rid_root):
    hosts, B = ["a", "b", "c"], 4
    pairs = {h: _pair(rid_root, B, 5, h, hosts) for h in hosts}
    spes = {h: dl.steps_per_epoch() for h, (dl, _) in pairs.items()}
    assert len(set(spes.values())) == 1
    assert spes == {h: ref.steps_per_epoch() for h, (_, ref) in pairs.items()}
    n = spes["a"]
    seen = {}
    for h, (dl, ref) in pairs.items():
        got = []
        for _ in range(n):
            bt, want = next(dl), next(ref)
            _same_batch(bt, want)
            got.append(bt["rid"][:, 0].copy())
        seen[h] = np.concatenate(got)
    for dl, ref in pairs.values():
        dl.stop()
        ref.stop()
    allr = np.concatenate(list(seen.values()))
    assert len(np.unique(allr)) == len(allr)
    plan = pairs["a"][0]._mesh_plan(0)
    assert len(allr) + plan.dropped_rows() == TOTAL
    for h, (dl, _) in pairs.items():
        owned = set(plan.owned_shards(h)) | set(dl._mesh_plan(1).owned_shards(h))
        assert set(dl.ds.shards_touched()) <= owned
    ref_ds = RaDataset(rid_root)
    for h in hosts:
        assert np.array_equal(ref_ds.gather(plan.host_order(h)[: n * B])["rid"][:, 0], seen[h])


def test_loader_repartition_join_exactly_once(rid_root):
    start, B, T = ["a", "b"], 4, 3
    pairs = {h: _pair(rid_root, B, 13, h, start) for h in start}
    seen = {h: [] for h in start}
    for h, (dl, ref) in pairs.items():
        for _ in range(T):
            bt, want = next(dl), next(ref)
            _same_batch(bt, want)
            seen[h].append(bt["rid"][:, 0].copy())
    new = ["a", "b", "c"]
    for dl, ref in pairs.values():
        st_, rst = dl.repartition(new), ref.repartition(new)
        assert (st_.epoch, st_.step) == (rst.epoch, rst.step) == (0, T)
    segs = pairs["a"][0].mesh.segments_for(0)
    assert segs == pairs["a"][1].mesh.segments_for(0)
    mesh_c, ref_c = DataMesh("c", new), jmesh.DataMesh("c", new)
    mesh_c.load_segments(0, segs)
    ref_c.load_segments(0, segs)
    dl_c = DataLoader(RaDataset(rid_root), B, seed=13, mesh=mesh_c)
    rf_c = jdata.DataLoader(jdata.RaDataset(rid_root), B, seed=13, mesh=ref_c)
    dl_c.seek(0, T)
    rf_c.seek(0, T)
    pairs["c"], seen["c"] = (dl_c, rf_c), []
    spe = pairs["a"][0].steps_per_epoch()
    assert spe > T and spe == pairs["a"][1].steps_per_epoch()
    for h, (dl, ref) in pairs.items():
        while len(seen[h]) < spe - (T if h == "c" else 0):
            bt, want = next(dl), next(ref)
            _same_batch(bt, want)
            seen[h].append(bt["rid"][:, 0].copy())
        dl.stop()
        ref.stop()
    allr = np.concatenate([np.concatenate(v) for v in seen.values()])
    assert len(np.unique(allr)) == len(allr)
    assert len(allr) == T * B * 2 + (spe - T) * B * 3


def test_loader_repartition_leave_exactly_once(rid_root):
    hosts, B, T = ["a", "b", "c"], 4, 2
    pairs = {h: _pair(rid_root, B, 11, h, hosts) for h in hosts}
    seen = {h: [] for h in hosts}
    for h, (dl, ref) in pairs.items():
        for _ in range(T):
            bt, want = next(dl), next(ref)
            _same_batch(bt, want)
            seen[h].append(bt["rid"][:, 0].copy())
    survivors = ["a", "b"]
    for h in survivors:
        dl, ref = pairs[h]
        assert dl.repartition(survivors).step == ref.repartition(survivors).step == T
    for x in pairs["c"]:
        x.stop()
    spe = pairs["a"][0].steps_per_epoch()
    for h in survivors:
        dl, ref = pairs[h]
        while len(seen[h]) < spe:
            bt, want = next(dl), next(ref)
            _same_batch(bt, want)
            seen[h].append(bt["rid"][:, 0].copy())
        dl.stop()
        ref.stop()
    allr = np.concatenate([np.concatenate(v) for v in seen.values()])
    assert len(np.unique(allr)) == len(allr)
    assert len(allr) == T * B * 3 + (spe - T) * B * 2


def test_mesh_state_resume_after_repartition(rid_root):
    B, hosts = 4, ["a", "b"]
    loaders = {h: DataLoader(RaDataset(rid_root), B, seed=21, mesh=DataMesh(h, hosts))
               for h in hosts}
    for h in hosts:
        _drain(loaders[h], 2)
    for h in hosts:
        loaders[h].repartition(["a"])
    loaders["b"].stop()
    bt = next(loaders["a"])
    st_ = bt["_state"]
    assert st_.mesh_segments == [(0, ("a", "b")), (2, ("a",))]
    rt = LoaderState.from_dict(st_.to_dict())
    assert rt.__dict__ == st_.__dict__
    follow = next(loaders["a"])
    loaders["a"].stop()
    # a fresh loader restored from the state reproduces the follower, in
    # either package
    port = DataLoader(RaDataset(rid_root), B, seed=21, mesh=DataMesh("a", hosts))
    ref = jdata.DataLoader(jdata.RaDataset(rid_root), B, seed=21, mesh=jmesh.DataMesh("a", hosts))
    for dl2, state in ((port, rt), (ref, jdata.LoaderState.from_dict(st_.to_dict()))):
        dl2.restore(state)
        nxt = next(dl2)
        dl2.stop()
        assert nxt["_state"].__dict__ == follow["_state"].__dict__
        assert np.array_equal(nxt["rid"], follow["rid"])


def test_single_host_defaults_byte_identical(rid_root):
    dl = DataLoader(RaDataset(rid_root), 16, seed=4)
    got = [next(dl) for _ in range(4)]
    dl.stop()
    order = np.random.default_rng((4, 0)).permutation(np.arange(TOTAL))
    for t, bt in enumerate(got):
        assert np.array_equal(bt["rid"][:, 0], order[t * 16 : (t + 1) * 16])
        assert (bt["_state"].epoch, bt["_state"].step) == (0, t)


def test_steps_per_epoch_uniform_nonmesh(rid_root):
    ds, rds = RaDataset(rid_root), jdata.RaDataset(rid_root)
    for hosts in (2, 3, 7):
        spes = {DataLoader(ds, 8, host_id=h, host_count=hosts).steps_per_epoch()
                for h in range(hosts)}
        assert spes == {jdata.DataLoader(rds, 8, host_id=0, host_count=hosts).steps_per_epoch()}
        spe = spes.pop()
        dl = DataLoader(ds, 8, host_id=hosts - 1, host_count=hosts)
        assert dl.stats()["dropped_tail_rows"] == TOTAL - spe * 8 * hosts


def test_zero_steps_is_sticky_error(rid_root):
    dl = DataLoader(RaDataset(rid_root), TOTAL + 1, mesh=DataMesh("a", ["a"]))
    with pytest.raises(RawArrayError, match="zero steps"):
        next(dl)
    with pytest.raises(RawArrayError):
        next(dl)
    dl.stop()


# ---- observability --------------------------------------------------------


def test_owners_table_and_racat(rid_root, capsys):
    table = owners_table(rid_root, ["a", "b", "c"])
    assert table == jmesh.owners_table(rid_root, ["a", "b", "c"])
    assert len(table["shards"]) == TOTAL // SHARD_ROWS
    assert table["total_rows"] == TOTAL
    assert table["total_bytes"] == TOTAL * W * 8
    assert sum(t["bytes"] for t in table["per_host"].values()) == table["total_bytes"]
    assert table["imbalance"] >= 1.0
    # both packages' CLIs print the same table, from the manifest alone
    assert jracat.main(["owners", rid_root, "--hosts", "3"]) == 0
    want = capsys.readouterr().out
    assert tracat.main(["owners", rid_root, "--hosts", "3"]) == 0
    out = capsys.readouterr().out
    assert out == want
    assert "imbalance" in out and "host0" in out and "shard" in out


def test_aggregate_stats_straggler():
    stats = [
        {"host_id": 0.0, "loader_produce_s": 1.0, "loader_wait_s": 0.1,
         "batches": 10.0, "dropped_tail_rows": 5.0},
        {"host_id": 1.0, "loader_produce_s": 3.0, "loader_wait_s": 0.2,
         "batches": 10.0, "dropped_tail_rows": 5.0},
    ]
    agg = aggregate_stats(stats)
    assert agg == jmesh.aggregate_stats(stats)
    assert agg["hosts"] == 2.0 and agg["batches"] == 20.0
    assert agg["loader_produce_s"] == 4.0 and agg["loader_produce_s_max"] == 3.0
    assert agg["straggler_host"] == 1.0 and agg["produce_skew"] == 1.5
    assert agg["dropped_tail_rows"] == 5.0


def test_loader_stats_are_aggregatable(rid_root):
    hosts = ["a", "b"]
    per = []
    for h in hosts:
        dl, ref = _pair(rid_root, 8, 2, h, hosts)
        for _ in range(2):
            _same_batch(next(dl), next(ref))
        dl.stop()
        ref.stop()
        per.append(dl.stats())
        assert per[-1]["dropped_tail_rows"] == ref.stats()["dropped_tail_rows"]
    agg = aggregate_stats(per)
    assert agg["hosts"] == 2.0 and agg["batches"] == 4.0
    assert "straggler_host" in agg and "dropped_tail_rows" in agg


# ---- device / global assembly ---------------------------------------------


@pytest.mark.parametrize("which", ["rid", "quantized"])
def test_device_loader_global_single_host(rid_root, quant_root, which):
    """A mesh loader's DeviceLoader yields DTensors (a one-rank gloo mesh on
    the CPU), each equal to the reference's mesh batch: the quantized field
    decoded by the device path, the reference's host decode bit for bit."""
    root, B = (rid_root, 8) if which == "rid" else (quant_root, 16)
    dev = DeviceLoader(DataLoader(RaDataset(root), B, seed=2, mesh=DataMesh("solo", ["solo"])),
                       device="cpu")
    assert dev.global_arrays
    ref = jdata.DataLoader(jdata.RaDataset(root), B, seed=2,
                           mesh=jmesh.DataMesh("solo", ["solo"]))
    try:
        for _ in range(3):
            bt, want = next(dev), next(ref)
            assert bt["_state"].__dict__ == want["_state"].__dict__
            for f in want:
                if f == "_state":
                    continue
                g = bt[f]
                assert isinstance(g, DTensor) and tuple(g.shape) == want[f].shape
                assert g.device_mesh.mesh_dim_names == ("data",)
                local = g.to_local()
                assert local.dtype == torch.from_numpy(want[f]).dtype
                assert torch.equal(local, torch.from_numpy(np.asarray(want[f])))
                assert torch.equal(g.full_tensor(), local)
    finally:
        dev.stop()
        ref.stop()


def test_global_arrays_needs_a_mesh_and_one_process_per_host(rid_root):
    with pytest.raises(RawArrayError, match="requires DataLoader"):
        DeviceLoader(DataLoader(RaDataset(rid_root), 8), global_arrays=True, device="cpu")
    with pytest.raises(RawArrayError, match="one process per mesh host"):
        DeviceLoader(DataLoader(RaDataset(rid_root), 8, mesh=DataMesh("a", ["a", "b"])),
                     device="cpu")
    # opting out keeps per-host tensors (no process group needed)
    dev = DeviceLoader(DataLoader(RaDataset(rid_root), 8, seed=2, mesh=DataMesh("a", ["a", "b"])),
                       global_arrays=False, device="cpu")
    ref = jdata.DataLoader(jdata.RaDataset(rid_root), 8, seed=2,
                           mesh=jmesh.DataMesh("a", ["a", "b"]))
    try:
        bt, want = next(dev), next(ref)
        assert not isinstance(bt["rid"], DTensor)
        assert np.array_equal(bt["rid"].numpy(), want["rid"])
    finally:
        dev.stop()
        ref.stop()
    assert not dist.is_initialized()


def test_make_global_batch_world_of_one():
    sharding = tmesh.data_sharding(device="cpu")
    rows = np.arange(12, dtype=np.int64).reshape(6, 2)
    g = tmesh.make_global_batch({"x": rows}, 1, sharding=sharding, detach=True)["x"]
    assert isinstance(g, DTensor) and tuple(g.shape) == (6, 2)
    assert np.array_equal(g.to_local().numpy(), rows)
    assert np.shares_memory(g.to_local().numpy(), rows) is False
    with pytest.raises(RawArrayError, match="mesh of 2 devices"):
        tmesh.make_global_batch({"x": rows}, 2, sharding=sharding)
    with pytest.raises(RawArrayError, match="one process drives one device"):
        tmesh.make_global_batch({"x": rows}, 1, sharding=sharding,
                                local_devices=[torch.device("cpu")] * 2)
    with pytest.raises(RawArrayError, match="does not split over 4 local devices"):
        tmesh.make_global_batch({"x": rows}, 1, sharding=sharding,
                                local_devices=[torch.device("cpu")] * 4)


def _run_ranks(script, world, tmp_path, **env):
    """Run ``script`` as ``world`` gloo ranks meeting through a FileStore
    under ``tmp_path``; returns each rank's stdout."""
    base = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")])),
        RA_STORE=str(tmp_path / "store"), RA_WORLD=str(world), OMP_NUM_THREADS="1",
        **{k: str(v) for k, v in env.items()})
    procs = [subprocess.Popen([sys.executable, "-c", script], env=dict(base, RA_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, (out, err)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


_RANK_HEAD = r"""
import json, os
import numpy as np, torch, torch.distributed as dist
rank, world = int(os.environ["RA_RANK"]), int(os.environ["RA_WORLD"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["RA_STORE"], world),
                        rank=rank, world_size=world)
"""

_SIM = _RANK_HEAD + r"""
try:
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset
    from repro_torch.distributed.data_mesh import DataMesh
    from torch.distributed.tensor import DTensor

    hosts = [f"h{i}" for i in range(world)]
    B = int(os.environ["RA_B"])
    dev = DeviceLoader(DataLoader(RaDataset(os.environ["RA_ROOT"]), B, seed=3,
                                  mesh=DataMesh(hosts[rank], hosts)), device="cpu")
    spe = dev.steps_per_epoch()
    assert spe > 0
    rows, sums = [], []
    for t in range(min(spe, 3)):
        g = next(dev)["rid"]
        assert isinstance(g, DTensor) and tuple(g.shape) == (B * world, 2), g.shape
        rows.append(g.to_local()[:, 0].tolist())
        sums.append(int(g.sum().full_tensor()))  # a collective over the global batch
    dev.stop()
    print(json.dumps({"rank": rank, "spe": spe, "rows": rows, "sums": sums}))
finally:
    dist.destroy_process_group()
"""


def test_global_assembly_simulated_four_hosts(tmp_path):
    """Four mesh hosts as four gloo ranks: each rank's global DeviceLoader
    declares its local batch as its block of one global DTensor, and a sum
    over the global tensor (an all-reduce) equals the sum of the four
    hosts' local batches from the JAX package's mesh loaders."""
    root = str(tmp_path / "sim_ds")
    b = DatasetBuilder(root, {"rid": ((2,), np.int64)}, shard_rows=8)
    ids = np.arange(512, dtype=np.int64)
    b.append(rid=np.stack([ids, ids], axis=1))
    b.finish()
    hosts, B = ["h0", "h1", "h2", "h3"], 4
    outs = [json.loads(o.strip().splitlines()[-1])
            for o in _run_ranks(_SIM, 4, tmp_path, RA_ROOT=root, RA_B=B)]
    refs = [jdata.DataLoader(jdata.RaDataset(root), B, seed=3, mesh=jmesh.DataMesh(h, hosts))
            for h in hosts]
    try:
        spe = refs[0].steps_per_epoch()
        assert {o["spe"] for o in outs} == {spe}
        for t in range(min(spe, 3)):
            batches = [next(dl)["rid"] for dl in refs]
            want = sum(int(b.sum()) for b in batches)
            for o, bt in zip(outs, batches):
                assert o["rows"][t] == bt[:, 0].tolist()
                assert o["sums"][t] == want
    finally:
        for dl in refs:
            dl.stop()


_RESTORE = _RANK_HEAD + r"""
try:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import restore_naive, restore_pipelined, shardings_from_specs

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    like = {"w": torch.empty(96, 64), "inner": {"b": torch.empty(64), "k": torch.empty(32, 48)}}
    specs = {"w": ("data", None), "inner": {"b": None, "k": (None, "data")}}
    sh = shardings_from_specs(mesh, specs)
    out = {}
    for name, fn in (("pipelined", restore_pipelined), ("naive", restore_naive)):
        got, _, _ = fn(os.environ["RA_CKPT"], like, device="cpu", shardings=sh)
        assert got["w"].device_mesh is mesh and tuple(got["w"].shape) == (96, 64)
        out[name] = {"w": got["w"].to_local().numpy().tolist(),
                     "k": got["inner"]["k"].to_local().numpy().tolist(),
                     "b": got["inner"]["b"].to_local().numpy().tolist()}
    # a sharded dimension that does not divide over the mesh raises
    bad = {"w": ("data", None), "inner": {"b": ("data",), "k": None}}
    try:
        restore_pipelined(os.environ["RA_ODD"], {"w": torch.empty(5, 4),
                          "inner": {"b": torch.empty(64), "k": torch.empty(32, 48)}},
                          device="cpu", shardings=shardings_from_specs(mesh, bad))
        out["uneven"] = "no error"
    except ValueError as e:
        out["uneven"] = str(e)
    print(json.dumps({"rank": rank, **out}))
finally:
    dist.destroy_process_group()
"""

_JAX_UNEVEN = r"""
import os
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           + os.environ.get("XLA_FLAGS", ""))
import numpy as np, jax
from jax.sharding import Mesh, PartitionSpec
from repro.checkpoint import restore_pipelined, shardings_from_specs
like = {"w": np.empty((5, 4), np.float32),
        "inner": {"b": np.empty(64, np.float32), "k": np.empty((32, 48), np.float32)}}
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
sh = shardings_from_specs(mesh, {"w": PartitionSpec("data", None),
                                 "inner": {"b": PartitionSpec("data"), "k": None}})
try:
    restore_pipelined(os.environ["RA_ODD"], like, shardings=sh)
    print("no error")
except ValueError as e:
    print("ValueError", e)
"""


def test_sharded_restore_two_ranks(tmp_path):
    """A u8 checkpoint restored onto a 2-rank gloo mesh: each rank's block of
    every sharded leaf (rows of ``w``, columns of ``k``; ``b`` replicated)
    equals the matching slice of the JAX package's restore of the same
    checkpoint, naive and pipelined alike; a sharded dimension that does not
    divide over the mesh raises a ValueError in both packages."""
    from repro.checkpoint import restore_pipelined as jrestore
    from repro.checkpoint import save_checkpoint as jsave

    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((96, 64)).astype(np.float32),
            "inner": {"b": rng.standard_normal(64).astype(np.float32),
                      "k": rng.standard_normal((32, 48)).astype(np.float32)}}
    ckpt = jsave(str(tmp_path / "ckpt"), 1, tree, chunked=True, quantize="u8")
    odd = jsave(str(tmp_path / "odd"), 1, {**tree, "w": tree["w"][:5, :4].copy()})
    like = {"w": np.empty((96, 64), np.float32),
            "inner": {"b": np.empty(64, np.float32), "k": np.empty((32, 48), np.float32)}}
    # the reference's sharded restore decodes on the host, as the port's does
    import jax
    from jax.sharding import Mesh, PartitionSpec
    from repro.checkpoint import shardings_from_specs as jshardings

    jsh = jshardings(Mesh(np.array(jax.devices()[:1]), ("data",)),
                     {"w": PartitionSpec("data", None),
                      "inner": {"b": None, "k": PartitionSpec(None, "data")}})
    want, _, _ = jrestore(ckpt, like, shardings=jsh)
    want = {"w": np.asarray(want["w"]), "b": np.asarray(want["inner"]["b"]),
            "k": np.asarray(want["inner"]["k"])}
    outs = [json.loads(o.strip().splitlines()[-1])
            for o in _run_ranks(_RESTORE, 2, tmp_path, RA_CKPT=ckpt, RA_ODD=odd)]
    for r, o in enumerate(outs):
        for path in ("pipelined", "naive"):
            got = {k: np.asarray(v, np.float32) for k, v in o[path].items()}
            assert np.array_equal(got["w"], want["w"][r * 48:(r + 1) * 48])
            assert np.array_equal(got["k"], want["k"][:, r * 24:(r + 1) * 24])
            assert np.array_equal(got["b"], want["b"])
        assert "does not divide over the 2 devices" in o["uneven"]
    env = dict(os.environ, RA_ODD=odd, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")])))
    ref = subprocess.run([sys.executable, "-c", _JAX_UNEVEN], env=env, capture_output=True,
                         text=True, timeout=RANK_TIMEOUT)
    assert ref.returncode == 0, ref.stderr
    assert ref.stdout.startswith("ValueError"), ref.stdout


# ---- training on a global batch over two processes -------------------------

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=256, max_seq=64)
TRAIN_STEPS, TRAIN_B = 3, 4
LOSS_TOL, DRIFT_CAP = 1e-5, 3e-2  # tests/test_torch_train.py's loss tolerance

_LOOP = r"""
from repro_torch.configs import get_config
cfg = get_config("paper_lm").with_(**json.loads(os.environ["RA_TINY"]))
hosts = ["h0", "h1"]
steps, B = int(os.environ["RA_STEPS"]), int(os.environ["RA_B"])
lr = dict(lr=3e-3, warmup_steps=2, total_steps=50)
ckpt = os.path.join(os.environ["RA_OUT"], f"ck_{os.environ['RA_PKG']}_{rank}")
"""

_JAX_TRAIN = r"""
import json, os
rank = int(os.environ["RA_RANK"])
import jax
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address="localhost:" + os.environ["RA_PORT"],
                           num_processes=2, process_id=rank)
import numpy as np
""" + _LOOP + r"""
from repro.data import DataLoader, DeviceLoader, RaDataset
from repro.distributed.data_mesh import DataMesh
from repro.distributed.optimizer import AdamWConfig
from repro.models import build_model
from repro.train import TrainLoopConfig, train
from repro.configs import get_config as jax_config
model = build_model(jax_config("paper_lm").with_(**json.loads(os.environ["RA_TINY"])))
if rank == 0:  # train() draws these same weights (one hash seed for both ranks)
    flat = jax.tree_util.tree_flatten_with_path(model.init(jax.random.PRNGKey(0)))[0]
    np.savez(os.environ["RA_INIT"], **{"/".join(k.key for k in path): np.asarray(v)
                                       for path, v in flat})
loader = DeviceLoader(DataLoader(RaDataset(os.environ["RA_ROOT"]), B, seed=0,
                                 mesh=DataMesh(hosts[rank], hosts)))
out = train(model, loader, TrainLoopConfig(steps=steps, ckpt_every=1000, ckpt_dir=ckpt,
                                           log_every=1000, adamw=AdamWConfig(**lr)),
            resume=False)
print(json.dumps({"rank": rank, "losses": [float(x) for x in out["losses"]]}))
jax.distributed.shutdown()
"""

_PORT_TRAIN = _RANK_HEAD + _LOOP + r"""
try:
    import time
    from repro_torch.data import DataLoader, DeviceLoader, RaDataset
    from repro_torch.distributed.data_mesh import DataMesh
    from repro_torch.distributed.optimizer import AdamWConfig
    from repro_torch.models import build_model
    from repro_torch.models.convert import load_params, params_from_jax
    from repro_torch.train import TrainLoopConfig, train

    while not os.path.exists(os.environ["RA_INIT"]):  # the JAX rank 0 writes it
        time.sleep(0.1)
    time.sleep(0.5)
    tree = {}
    with np.load(os.environ["RA_INIT"]) as z:
        for key in z.files:
            node = tree
            *path, last = key.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[last] = z[key]
    model = build_model(cfg, device="cpu")
    load_params(model, params_from_jax(tree))
    loader = DeviceLoader(DataLoader(RaDataset(os.environ["RA_ROOT"]), B, seed=0,
                                     mesh=DataMesh(hosts[rank], hosts)), device="cpu")
    out = train(model, loader, TrainLoopConfig(steps=steps, ckpt_every=1000, ckpt_dir=ckpt,
                                               log_every=1000, adamw=AdamWConfig(**lr)),
                resume=False)
    print(json.dumps({"rank": rank, "losses": out["losses"]}))
finally:
    dist.destroy_process_group()
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_on_a_global_batch_over_two_processes(tmp_path):
    """Two mesh hosts as two processes in each package: the JAX package's
    ``train()`` steps its jitted step on the global array (XLA makes it
    data-parallel), the port's on its DTensor with the gradients averaged
    over the mesh. From the same weights over the same rows, every rank of
    both packages reports the same losses, the two packages within
    ``tests/test_torch_train.py``'s tolerance."""
    from repro_torch.data import make_token_dataset

    root = str(tmp_path / "ds")
    make_token_dataset(root, n_docs=128, seq_len=32, vocab=TINY["vocab"], shard_rows=8)
    init = str(tmp_path / "init.npz")
    env = dict(RA_ROOT=root, RA_INIT=init, RA_TINY=json.dumps(TINY), RA_STEPS=TRAIN_STEPS,
               RA_B=TRAIN_B, RA_OUT=tmp_path)
    base = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")])),
        OMP_NUM_THREADS="1", **{k: str(v) for k, v in env.items()})
    jax_env = dict(base, RA_PKG="jax", RA_PORT=str(_free_port()), PYTHONHASHSEED="0",
                   JAX_PLATFORMS="cpu")
    jax_procs = [subprocess.Popen([sys.executable, "-c", _JAX_TRAIN],
                                  env=dict(jax_env, RA_RANK=str(r)), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        port = _run_ranks(_PORT_TRAIN, 2, tmp_path, RA_PKG="torch", **env)
        ref = []
        for p in jax_procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, (out, err)
            ref.append(out)
    finally:
        for p in jax_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ref = [json.loads(o.strip().splitlines()[-1])["losses"] for o in ref]
    port = [json.loads(o.strip().splitlines()[-1])["losses"] for o in port]
    assert ref[0] == ref[1] and port[0] == port[1]
    assert len(port[0]) == len(ref[0]) == TRAIN_STEPS
    for k, (g, w) in enumerate(zip(port[0], ref[0])):
        tol = min(LOSS_TOL * 10 ** k, DRIFT_CAP)
        assert abs(g - w) <= tol * abs(w), f"step {k}: {g} vs {w} (rtol {tol})"
