"""Checkpoints across the two packages, and the port's cold start.

A checkpoint written by the JAX package (``repro.checkpoint``) restores bit
for bit through the port's ``load_checkpoint``, ``restore_naive`` and
``restore_pipelined``, and one written by the port restores bit for bit
through the JAX package, for f32 and bf16 leaves stored raw, crc32,
chunked + zlib and ``quantize="u8"``. Both packages write the same leaf
files and manifest entries. The port's runs repeat with its ``core.dtypes``
made to act as if ``ml_dtypes`` were absent, as on the machine with the
card. The cold-start checks mirror ``tests/test_coldstart.py``.

With ``quantize="u8"`` both writers store bf16 leaves verbatim (the JAX
package's because numpy does not count ``ml_dtypes.bfloat16`` as floating),
so the files are identical for every case. A quantized entry of bf16 origin,
which neither writer makes, still decodes through both packages' readers.
Quantized leaves are compared with the JAX package's host decode
(``load_checkpoint``), which the port's decode equals bit for bit; the
JAX package's own ``restore_pipelined`` decodes them through an XLA path
that contracts the multiply-add (ROADMAP.md, faults), so it is held to
the raw and chunked cases.
"""

import json
import os

import numpy as np
import pytest
import torch

import ml_dtypes

import repro.checkpoint as jck
import repro_torch.checkpoint as tck
import repro_torch.core as tra
import repro_torch.core.dtypes as tdtypes
from repro_torch.checkpoint import store as tstore
from repro_torch.core.spec import RawArrayError
from repro_torch.models.convert import params_from_jax

KWS = [
    {},
    {"crc32": True},
    {"chunked": True, "codec": "zlib"},
    {"quantize": "u8"},
    {"chunked": True, "quantize": "u8"},
]
KW_IDS = ["raw", "crc32", "chunked-zlib", "u8", "chunked-u8"]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((96, 64)).astype(np.float32),
        "e": rng.standard_normal((40, 16)).astype(ml_dtypes.bfloat16),
        "inner": {
            "b": rng.standard_normal((64,)).astype(np.float32),
            "k": rng.standard_normal((32, 48)).astype(ml_dtypes.bfloat16),
            "step": np.arange(5, dtype=np.int32),
        },
    }


def _jax_like(tree):
    return {k: _jax_like(v) if isinstance(v, dict) else np.empty(v.shape, v.dtype)
            for k, v in tree.items()}


def _bits(x) -> np.ndarray:
    """Comparable bits of a torch tensor or a numpy/jax array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_bit_equal(got, want):
    g, w = tstore.flatten(got, "p"), tstore.flatten(want, "p")
    assert g.keys() == w.keys()
    for name in w:
        gb, wb = _bits(g[name]), _bits(w[name])
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, name
        np.testing.assert_array_equal(gb, wb, err_msg=name)


@pytest.fixture(params=[True, False], ids=["ml_dtypes", "no_ml_dtypes"])
def port_dtypes(request, monkeypatch):
    """The port's dtype table with ``ml_dtypes`` present or hidden."""
    if not request.param:
        monkeypatch.setattr(tdtypes, "_HAVE_ML_DTYPES", False)
        monkeypatch.setattr(tdtypes, "_BFLOAT16", None)
    return request.param


def _port_restores(path, like):
    """The checkpoint through all three port readers (on the CPU)."""
    loaded, _, _ = tck.load_checkpoint(path, like)
    naive, _, _ = tck.restore_naive(path, like, device="cpu")
    st = tck.ColdStartStats()
    pipe, _, _ = tck.restore_pipelined(path, like, device="cpu", stats=st)
    return loaded, naive, pipe, st


@pytest.mark.parametrize("kw", KWS, ids=KW_IDS)
def test_jax_checkpoint_restores_through_the_port(tmp_path, kw, port_dtypes):
    tree = _tree(1)
    path = jck.save_checkpoint(str(tmp_path), 3, tree, **kw)
    want, _, _ = jck.load_checkpoint(path, _jax_like(tree))
    like = params_from_jax(_jax_like(tree))
    loaded, naive, pipe, st = _port_restores(path, like)
    for got in (loaded, naive, pipe):
        _assert_bit_equal(got, want)
    assert st.leaves == 5
    assert st.dequant_leaves == (2 if "quantize" in kw else 0)  # the JAX writer's f32 leaves
    assert st.logical_bytes == sum(a.nbytes for a in tstore.flatten(tree, "p").values())


@pytest.mark.parametrize("kw", KWS, ids=KW_IDS)
def test_port_checkpoint_restores_through_jax(tmp_path, kw, port_dtypes):
    tree = params_from_jax(_tree(2))
    path = tck.save_checkpoint(str(tmp_path), 4, tree, extra={"note": "port"}, **kw)
    own, _, extra = tck.load_checkpoint(path, tree)
    assert extra == {"note": "port"}
    if "quantize" not in kw:
        _assert_bit_equal(own, tree)
    jax_loaded, _, _ = jck.load_checkpoint(path, _jax_like(_tree(2)))
    _assert_bit_equal(own, jax_loaded)
    if "quantize" not in kw:
        jax_pipe, _, _ = jck.restore_pipelined(path, _jax_like(_tree(2)))
        _assert_bit_equal(own, jax_pipe)


@pytest.mark.parametrize("kw", KWS, ids=KW_IDS)
def test_both_packages_write_the_same_files(tmp_path, kw, port_dtypes):
    tree = _tree(3)
    jpath = jck.save_checkpoint(str(tmp_path / "jax"), 1, tree, **kw)
    tpath = tck.save_checkpoint(str(tmp_path / "port"), 1, params_from_jax(tree), **kw)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tpath, "manifest.json")) as f:
        tman = json.load(f)
    assert tman["leaves"].keys() == jman["leaves"].keys()
    assert sorted(os.listdir(tpath)) == sorted(os.listdir(jpath))
    for name, entry in jman["leaves"].items():
        if entry["dtype"] == "bfloat16":
            assert "quant" not in entry  # both writers keep bf16 verbatim
        assert tman["leaves"][name] == entry
        with open(os.path.join(jpath, entry["file"]), "rb") as a, \
                open(os.path.join(tpath, entry["file"]), "rb") as b:
            assert a.read() == b.read(), entry["file"]


def _requantize_as_bf16(path, name, codes_of):
    """Rewrite leaf ``name`` of a checkpoint as u8 codes of bf16 origin: the
    entry a writer that quantizes bf16 would make (neither package's does)."""
    man_path = os.path.join(path, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    entry = man["leaves"][name]
    info = tra.quant.quant_params(codes_of, "u8")
    info.orig_dtype = "bfloat16"
    tra.write(os.path.join(path, entry["file"]), info.quantize(codes_of), metadata=info.encode())
    entry.update(quant=info.to_dict(), stored_dtype="uint8")
    with open(man_path, "w") as f:
        json.dump(man, f)
    return info


def test_quantized_bf16_leaf_keeps_its_orig_dtype(tmp_path, port_dtypes):
    tree = params_from_jax(_tree(4))
    path = tck.save_checkpoint(str(tmp_path), 1, tree, quantize="u8")
    with open(os.path.join(path, "manifest.json")) as f:
        assert "quant" not in json.load(f)["leaves"]["param__inner__k"]
    info = _requantize_as_bf16(path, "param__inner__k", tree["inner"]["k"].float().numpy())
    meta = tra.read_quant_metadata(os.path.join(path, "param__inner__k.ra"))
    assert meta.orig_dtype == "bfloat16"
    want = info.dequantize(info.quantize(tree["inner"]["k"].float().numpy()))
    loaded, naive, pipe, st = _port_restores(path, tree)
    for got in (loaded, naive, pipe):
        k = got["inner"]["k"]
        assert k.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(k), _bits(want))
        assert got["inner"]["step"].dtype == torch.int32  # non-float leaves stay verbatim
    assert st.dequant_leaves == 3  # the two f32 leaves and the rewritten bf16 one
    jax_loaded, _, _ = jck.load_checkpoint(path, _jax_like(_tree(4)))
    np.testing.assert_array_equal(_bits(jax_loaded["inner"]["k"]), _bits(want))


def test_shape_mismatch_raises(tmp_path):
    tree = params_from_jax(_tree(5))
    path = tck.save_checkpoint(str(tmp_path), 1, tree)
    bad = dict(tree, w=torch.empty(8, 8))
    for restore in (tck.load_checkpoint,
                    lambda p, t: tck.restore_naive(p, t, device="cpu"),
                    lambda p, t: tck.restore_pipelined(p, t, device="cpu")):
        with pytest.raises(ValueError, match="checkpoint"):
            restore(path, bad)


def test_inflight_cap_bounds_peak_and_admits_an_oversized_leaf(tmp_path):
    tree = params_from_jax(_tree(6))
    path = tck.save_checkpoint(str(tmp_path), 1, tree)
    largest = max(t.numel() * t.element_size() for t in tstore.flatten(tree, "p").values())
    st = tck.ColdStartStats()
    got, _, _ = tck.restore_pipelined(path, tree, device="cpu", inflight_bytes=largest // 4,
                                      stats=st)
    _assert_bit_equal(got, tree)
    assert 0 < st.peak_inflight_bytes <= largest


def test_local_overwrite_mid_restore_fails_fast(tmp_path):
    tree = params_from_jax(_tree(7))
    path = tck.save_checkpoint(str(tmp_path), 1, tree, chunked=True)
    leaf = os.path.join(path, "param__w.ra")

    def clobber():
        tra.write(leaf, np.asarray(_tree(8)["w"]), chunked=True)
        st = os.stat(leaf)
        os.utime(leaf, ns=(st.st_mtime_ns + 10_000_000, st.st_mtime_ns + 10_000_000))

    with pytest.raises(RawArrayError, match="during restore"):
        tck.restore_pipelined(path, tree, device="cpu", _after_resolve=clobber)


def test_restores_default_to_the_card(tmp_path, monkeypatch):
    tree = params_from_jax(_tree(9))
    path = tck.save_checkpoint(str(tmp_path), 1, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for restore in (tck.restore_pipelined, tck.restore_naive):
        with pytest.raises(RawArrayError, match="no CUDA device"):
            restore(path, tree)
    with pytest.raises(NotImplementedError, match="item 8"):
        tck.restore_pipelined(path, tree, device="cpu", shardings={})
    # a URL save goes through the upload plane, which wants a bearer token
    with pytest.raises(RawArrayError, match="bearer token"):
        tck.save_checkpoint("http://127.0.0.1:1/ckpt", 1, tree)
    assert tck.latest_step(str(tmp_path)) == 1
