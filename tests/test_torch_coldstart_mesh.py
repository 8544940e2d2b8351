"""The port's resharded cold start and its train CLI's data mesh, held to the
JAX package's: a mirror of ``tests/test_coldstart.py``'s
``test_resharded_restore_onto_mesh`` (local and URL, naive against
pipelined, a shardings tree of the wrong length) on a one-rank gloo mesh on
the CPU, and of ``launch/train.py``'s mesh (``--mesh-hosts``/``--mesh-host``,
else ``RA_MESH_HOSTS``/``RA_MESH_HOST``): the port's CLI must feed the rows
the reference's CLI feeds under the same environment. Bit-equal
throughout."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

import jax
from jax.sharding import Mesh, PartitionSpec
import repro.checkpoint as jckpt
import repro.launch.train as jlaunch
import repro.train as jtrain
from repro.core.spec import RawArrayError as JaxRawArrayError
from repro_torch import remote
from repro_torch.checkpoint import (
    restore_naive,
    restore_pipelined,
    save_checkpoint,
    shardings_from_specs,
)
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import get_config
from repro_torch.core.spec import RawArrayError
from repro_torch.data import make_token_dataset
from repro_torch.distributed.data_mesh import data_sharding
import repro_torch.launch.train as tlaunch
import repro_torch.train as ttrain


@pytest.fixture(autouse=True)
def _no_process_group_left():
    """The one-rank mesh starts a process group in this process: each test
    leaves none behind."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture()
def served(tmp_path):
    server = remote.serve(str(tmp_path), port=0)
    try:
        yield str(tmp_path), server.url
    finally:
        server.shutdown()
        server.server_close()
        remote.close_readers()
        remote.reset_shared_cache()


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((96, 64)).astype(np.float32),
            "inner": {"b": rng.standard_normal((64,)).astype(np.float32),
                      "k": rng.standard_normal((32, 48)).astype(np.float32)}}


def _like(tree):
    return {k: _like(v) if isinstance(v, dict) else torch.empty(v.shape) for k, v in tree.items()}


def _cold():
    remote.close_readers()
    remote.reset_shared_cache()


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


# -------------------------------------------------- resharded onto a mesh
@pytest.mark.parametrize("transport", ["local", "url"])
def test_resharded_restore_onto_mesh(served, transport):
    root, base = served
    tree = _tree(3)
    p = save_checkpoint(root, 1, tree, chunked=True, quantize="u8")
    path = p if transport == "local" else f"{base}/{os.path.basename(p)}"

    mesh = data_sharding(device="cpu")[0]
    specs = {"w": ("data", None), "inner": {"b": None, "k": None}}
    sh = shardings_from_specs(mesh, specs)
    assert sh["w"] == (mesh, (Shard(0),)) and sh["inner"]["b"] == (mesh, (Replicate(),))

    # naive with the SAME shardings: sharded quantized leaves decode on the
    # host in both paths, so bit-exactness is by construction
    _cold()
    naive, _, _ = restore_naive(path, _like(tree), device="cpu", shardings=sh)
    _cold()
    pipe, _, _ = restore_pipelined(path, _like(tree), device="cpu", shardings=sh)
    for name, t in flatten(pipe, "param").items():
        assert isinstance(t, DTensor) and t.device_mesh == mesh, name
        assert torch.equal(_local(t), _local(flatten(naive, "param")[name])), name

    # the JAX package's restore of the same checkpoint onto its one-device mesh
    jmesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jsh = jckpt.shardings_from_specs(jmesh, {"w": PartitionSpec("data", None),
                                             "inner": {"b": None, "k": None}})
    jlike = jax.tree_util.tree_map(lambda x: np.empty(x.shape, x.dtype), tree)
    _cold()
    want, _, _ = jckpt.restore_pipelined(path, jlike, shardings=jsh)
    want = flatten(want, "param")
    for name, t in flatten(pipe, "param").items():
        assert np.array_equal(_local(t).numpy(), np.asarray(want[name])), name


def test_shardings_tree_length_mismatch(tmp_path):
    tree = _tree(4)
    p = jckpt.save_checkpoint(str(tmp_path), 1, tree)
    mesh = data_sharding(device="cpu")[0]
    short = shardings_from_specs(mesh, {"w": ("data", None), "inner": {"b": None}})
    for fn in (restore_pipelined, restore_naive):
        with pytest.raises(ValueError, match="shardings tree has 2 leaves, param tree has 3"):
            fn(p, _like(tree), device="cpu", shardings=short)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jshort = jckpt.shardings_from_specs(jmesh, {"w": PartitionSpec("data", None),
                                                "inner": {"b": None}})
    jlike = jax.tree_util.tree_map(lambda x: np.empty(x.shape, x.dtype), tree)
    with pytest.raises(ValueError, match="shardings tree has 2 leaves, param tree has 3"):
        jckpt.restore_pipelined(p, jlike, shardings=jshort)


def test_shardings_from_specs_names_mesh_axes():
    mesh = data_sharding(device="cpu")[0]
    got = shardings_from_specs(mesh, {"a": (None, "data"), "b": [None, ()]})
    assert got == {"a": (mesh, (Shard(1),)), "b": [(mesh, (Replicate(),)),
                                                   (mesh, (Replicate(),))]}
    with pytest.raises(ValueError, match="not in mesh"):
        shardings_from_specs(mesh, {"a": ("model",)})
    # the JAX package refuses an unknown axis name too
    with pytest.raises(ValueError, match="not found in mesh"):
        jckpt.shardings_from_specs(Mesh(np.array(jax.devices()[:1]), ("data",)),
                                   {"a": PartitionSpec("model")})


# ------------------------------------------------------ the train CLI's mesh
@pytest.fixture(scope="module")
def token_ds(tmp_path_factory):
    """Small shards, so two mesh hosts each own some."""
    root = str(tmp_path_factory.mktemp("tcli") / "ds")
    make_token_dataset(root, n_docs=64, seq_len=32, vocab=get_config("paper_lm").vocab,
                       shard_rows=8)
    return root


def _cli_loaders(monkeypatch, args):
    """The loader each package's train CLI hands its train loop, with the
    loop itself stubbed out."""
    got = {}

    def grab(key):
        def fake_train(model, loader, *a, **k):
            got[key] = loader
            return {"steps": 0, "wall_s": 0.0, "preempted": False}
        return fake_train

    monkeypatch.setattr(jtrain, "train", grab("jax"))
    monkeypatch.setattr(ttrain, "train", grab("torch"))
    assert jlaunch.main(args) == 0
    assert tlaunch.main(["--device", "cpu", *args]) == 0
    return got["torch"], got["jax"]


@pytest.mark.parametrize("how", ["env", "flags"])
def test_cli_mesh_feeds_the_reference_rows(token_ds, tmp_path, monkeypatch, how):
    """Under ``RA_MESH_HOSTS=h0,h1 RA_MESH_HOST=h0`` (or the flags) the port's
    CLI trains on host h0's rows of the mesh, batch for batch the reference
    CLI's, and on no other rows."""
    args = ["--dataset", token_ds, "--workdir", str(tmp_path), "--batch", "4", "--seed", "3"]
    if how == "env":
        monkeypatch.setenv("RA_MESH_HOSTS", "h0,h1")
        monkeypatch.setenv("RA_MESH_HOST", "h0")
    else:
        args += ["--mesh-hosts", "h0,h1", "--mesh-host", "h0"]
    port, ref = _cli_loaders(monkeypatch, args)
    try:
        assert port.mesh.hosts == ref.mesh.hosts == ("h0", "h1")
        assert port.mesh.host == ref.mesh.host == "h0"
        spe = ref.steps_per_epoch()
        assert port.steps_per_epoch() == spe and 0 < spe < 64 // 4
        for _ in range(spe):
            a, b = next(port), next(ref)
            assert a["_state"].__dict__ == b["_state"].__dict__
            assert np.array_equal(a["tokens"], b["tokens"])
    finally:
        port.stop()
        ref.stop()


def test_cli_without_mesh_reads_every_row(token_ds, tmp_path, monkeypatch):
    monkeypatch.delenv("RA_MESH_HOSTS", raising=False)
    monkeypatch.delenv("RA_MESH_HOST", raising=False)
    port, ref = _cli_loaders(monkeypatch, ["--dataset", token_ds, "--workdir", str(tmp_path),
                                           "--batch", "4"])
    assert port.mesh is None and ref.mesh is None
    assert port.steps_per_epoch() == ref.steps_per_epoch() == 64 // 4


def test_cli_mesh_flags_come_together(tmp_path, capsys):
    for flags in (["--mesh-hosts", "h0,h1"], ["--mesh-host", "h0"]):
        for main in (jlaunch.main, tlaunch.main):
            with pytest.raises(SystemExit):
                main(["--workdir", str(tmp_path), *flags])
            assert "must be given together" in capsys.readouterr().err


def test_cli_device_feed_needs_one_process_per_host(token_ds, tmp_path, monkeypatch):
    """Two mesh hosts in a one-process world: both packages' device feeds
    refuse to assemble global batches."""
    args = ["--dataset", token_ds, "--workdir", str(tmp_path), "--device-feed",
            "--mesh-hosts", "h0,h1", "--mesh-host", "h0"]
    with pytest.raises(JaxRawArrayError, match="one jax process per mesh host"):
        jlaunch.main(args)
    with pytest.raises(RawArrayError, match="one process per mesh host"):
        tlaunch.main(["--device", "cpu", *args])
    assert not dist.is_initialized()


def test_cli_device_feed_trains_on_a_one_host_mesh(token_ds, tmp_path, monkeypatch):
    """A one-host mesh with the device feed: global DTensor batches (a
    one-rank gloo group) reach the step as their local tensors, and the
    losses are the flagless mesh run's, which reads the same rows."""
    common = ["--device", "cpu", "--dataset", token_ds, "--batch", "2", "--steps", "2",
              "--ckpt-every", "10", "--device-feed", "--fresh"]
    out = tlaunch.run(tlaunch.parse_args(common + ["--workdir", str(tmp_path / "a"),
                                                   "--mesh-hosts", "h0", "--mesh-host", "h0"]))
    assert dist.is_initialized() and dist.get_world_size() == 1
    dist.destroy_process_group()
    monkeypatch.setenv("RA_MESH_HOSTS", "h0")
    monkeypatch.setenv("RA_MESH_HOST", "h0")
    again = tlaunch.run(tlaunch.parse_args(common + ["--workdir", str(tmp_path / "b")]))
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["losses"] == again["losses"]
