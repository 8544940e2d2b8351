"""The two packages' remote data planes speak one protocol and one layout.

The JAX package's server (``repro.remote``) serves and the port's client
(``repro_torch.remote``) reads, and the reverse; the port's
``RemoteWriter`` leaves on either server the bytes ``repro.core.write``
writes; checkpoints cross over a URL both ways bit for bit; and the port's
``ServeEngine`` restored from a URL gives the JAX engine's greedy tokens.
Every server is a real loopback HTTP server on an ephemeral port."""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

import repro.checkpoint as jck
import repro.core as jra
import repro.core.codec as jcodec
from repro import remote as jremote
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.serving import ServeEngine as JaxEngine
import repro_torch.checkpoint as tck
import repro_torch.core as tra
import repro_torch.core.codec as tcodec
import repro_torch.core.dtypes as tdtypes
from repro_torch import remote as tremote
from repro_torch.checkpoint.store import flatten
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServeEngine

TOKEN = "cross-token"
SERVERS = {"jax": jremote, "port": tremote}
CODECS = sorted(set(jcodec._by_name) & set(tcodec._by_name))
FILES = {"plain": {}, "crc32": {"crc32": True}, "meta": {"metadata": b"cross!"},
         **{f"chunked-{c}": {"chunked": True, "codec": c, "chunk_bytes": 4096}
            for c in CODECS},
         "chunked-zlib-crc32": {"chunked": True, "codec": "zlib", "chunk_bytes": 4096,
                                "crc32": True}}


@pytest.fixture(params=sorted(SERVERS))
def server(request, tmp_path):
    """(which, root, url) of an upload-enabled server of either package."""
    which = request.param
    srv = SERVERS[which].serve(str(tmp_path), port=0, upload_token=TOKEN)
    try:
        yield which, str(tmp_path), srv.url
    finally:
        srv.shutdown()
        srv.server_close()
        for mod in SERVERS.values():
            mod.close_readers()
            mod.reset_shared_cache()


def _arr(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 16, size=(257, 19), dtype=np.int64).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(FILES))
def test_each_client_reads_the_other_servers_files(server, kind):
    """``which`` serves what ``repro.core.write`` wrote; the other package's
    client reads it back bit for bit (payload, metadata, header)."""
    which, root, base = server
    client = tra if which == "jax" else jra
    arr = _arr(1)
    jra.write(os.path.join(root, "f.ra"), arr, **FILES[kind])
    url = f"{base}/f.ra"
    got = client.read(url, with_metadata=True)
    assert np.array_equal(np.asarray(got[0]), arr)
    assert got[1] == FILES[kind].get("metadata", b"")
    hdr = client.header_of(url)
    assert (tuple(hdr.shape), hdr.flags) == (arr.shape, jra.header_of(
        os.path.join(root, "f.ra")).flags)
    out = np.empty_like(arr)
    client.read_into(url, out)
    assert np.array_equal(out, arr)


@pytest.mark.parametrize("kind", ["plain", "crc32", "chunked-zlib", "chunked-raw"])
def test_port_remote_writer_matches_the_jax_write(server, tmp_path, kind):
    which, root, base = server
    kw = {k: v for k, v in FILES[kind].items()}
    arr = _arr(2)
    w = tremote.RemoteWriter(f"{base}/up/stream.ra", np.float32, (19,), token=TOKEN,
                             metadata=b"remote!", **kw)
    for lo in range(0, len(arr), 64):
        w.write_rows(arr[lo:lo + 64])
    w.finalize()
    local = tmp_path / "jax.ra"
    jra.write(str(local), arr, metadata=b"remote!", **kw)
    with open(os.path.join(root, "up", "stream.ra"), "rb") as f:
        assert f.read() == local.read_bytes()


def _jax_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((96, 64)).astype(np.float32),
        "e": rng.standard_normal((40, 16)).astype(ml_dtypes.bfloat16),
        "inner": {"b": rng.standard_normal((64,)).astype(np.float32),
                  "step": np.arange(5, dtype=np.int32)},
    }


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_bit_equal(got, want):
    g, w = flatten(got, "p"), flatten(want, "p")
    assert g.keys() == w.keys()
    for name in w:
        gb, wb = _bits(g[name]), _bits(w[name])
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, name
        np.testing.assert_array_equal(gb, wb, err_msg=name)


def _jax_like(tree):
    return {k: _jax_like(v) if isinstance(v, dict) else np.empty(v.shape, v.dtype)
            for k, v in tree.items()}


@pytest.fixture(params=[True, False], ids=["ml_dtypes", "no_ml_dtypes"])
def port_dtypes(request, monkeypatch):
    """The port's dtype table with ``ml_dtypes`` present or hidden (the
    machine with the card may lack it)."""
    if not request.param:
        monkeypatch.setattr(tdtypes, "_HAVE_ML_DTYPES", False)
        monkeypatch.setattr(tdtypes, "_BFLOAT16", None)
    return request.param


@pytest.mark.parametrize("kw", [{}, {"quantize": "u8"}, {"chunked": True, "quantize": "u8"}],
                         ids=["raw", "u8", "chunked-u8"])
def test_jax_checkpoint_restores_through_the_port_over_a_url(tmp_path, kw, port_dtypes):
    tree = _jax_tree(3)
    path = jck.save_checkpoint(str(tmp_path), 1, tree, **kw)
    like = params_from_jax(_jax_like(tree))
    local, _, _ = tck.restore_pipelined(path, like, device="cpu")
    srv = tremote.serve(str(tmp_path), port=0)
    try:
        url = f"{srv.url}/{os.path.basename(path)}"
        st = tck.ColdStartStats()
        got, _, _ = tck.restore_pipelined(url, like, device="cpu", stats=st)
        _assert_bit_equal(got, local)
        naive, _, _ = tck.restore_naive(url, like, device="cpu")
        _assert_bit_equal(naive, local)
        want, _, _ = jck.load_checkpoint(path, _jax_like(tree))
        _assert_bit_equal(got, want)
        assert st.dequant_leaves == (2 if "quantize" in kw else 0)
    finally:
        srv.shutdown()
        srv.server_close()
        tremote.close_readers()
        tremote.reset_shared_cache()


@pytest.mark.parametrize("kw", [{}, {"quantize": "u8"}, {"chunked": True, "crc32": True}],
                         ids=["raw", "u8", "chunked-crc32"])
def test_port_url_checkpoint_restores_through_the_jax_package(server, monkeypatch, kw):
    which, root, base = server
    monkeypatch.setenv("RA_REMOTE_TOKEN", TOKEN)
    tree = params_from_jax(_jax_tree(4))
    final = tck.save_checkpoint(f"{base}/ck", 7, tree, extra={"step": 7}, **kw)
    assert final == f"{base}/ck/step_00000007"
    jlike = _jax_like(_jax_tree(4))
    got, _, extra = jck.load_checkpoint(final, jlike)
    local, _, _ = jck.load_checkpoint(os.path.join(root, "ck", "step_00000007"), jlike)
    assert extra == {"step": 7}
    _assert_bit_equal(got, local)
    if not kw.get("quantize"):
        _assert_bit_equal(got, tree)
    back, _, _ = tck.load_checkpoint(final, tree)
    _assert_bit_equal(back, local)


def test_url_serve_engine_matches_the_jax_engine(tmp_path):
    cfg = jax_config("paper_lm").reduced()
    jmodel = jax_build(cfg)
    params = jmodel.init(jax.random.PRNGKey(3))
    path = jck.save_checkpoint(str(tmp_path), 1, params)
    prompts = np.random.default_rng(4).integers(1, cfg.vocab, (2, 16)).astype(np.int32)
    want = JaxEngine(jmodel, checkpoint=path).generate(prompts, max_new=8)

    srv = tremote.serve(str(tmp_path), port=0)
    try:
        url = f"{srv.url}/{os.path.basename(path)}"
        engine = ServeEngine(build_model(get_config("paper_lm").reduced(), device="meta"),
                             checkpoint=url, device="cpu")
        got = engine.generate(prompts, max_new=8)
        np.testing.assert_array_equal(got, want)
        assert engine.cold_start.leaves == len(jax.tree_util.tree_leaves(params))
    finally:
        srv.shutdown()
        srv.server_close()
        tremote.close_readers()
        tremote.reset_shared_cache()
