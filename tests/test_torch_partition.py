"""The port's spec tables (``distributed/{sharding,partition,steps}.py``,
``launch/{shapes,mesh}.py``) against the JAX package's, leaf by leaf, for
every arch on both production meshes. Meshes are ``{axis: size}`` dicts on
the port's side and ``AbstractMesh``es on the reference's, so no devices
are needed (as ``tests/test_distributed.py`` builds its tables)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import all_arch_ids, get_config as jax_config
from repro.distributed import optimizer as jopt
from repro.distributed import partition as jpart
from repro.distributed import sharding as jsh
from repro.distributed import steps as jsteps
from repro.launch import shapes as jshapes
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.distributed import optimizer as topt
from repro_torch.distributed import partition as tpart
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed import steps as tsteps
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shapes as tshapes
from repro_torch.models import build_model

POD = {"data": 16, "model": 16}
MULTIPOD = {"pod": 2, "data": 16, "model": 16}
MESHES = {"pod": POD, "multipod": MULTIPOD}


def _abstract(mesh):
    names, sizes = tuple(mesh), tuple(mesh.values())
    try:
        return AbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return AbstractMesh(sizes, names)


def _norm(spec, rank):
    """A spec as a tuple of ``rank`` entries, a one-axis tuple as its name
    (``PartitionSpec`` normalizes ``("data",)`` to ``"data"``)."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, (tuple, list)) else e)
    return tuple(out) + (None,) * (rank - len(out))


def _jax_flat(tree, like):
    """{path: (normalized spec)} of a reference spec tree, each padded to the
    rank of the matching leaf of ``like``."""
    specs = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    shapes = dict((jax.tree_util.keystr(p), x) for p, x in
                  jax.tree_util.tree_flatten_with_path(like)[0])
    out = {}
    for path, sp in specs:
        key = jax.tree_util.keystr(path)
        out["/".join(str(getattr(k, "key", k)) for k in path)] = _norm(sp, len(shapes[key].shape))
    return out


def _port_flat(tree, like):
    return {path: _norm(sp, len(leaf.shape)) for (path, sp), (_, leaf)
            in zip(tsteps._leaves_with_paths(tree), tsteps._leaves_with_paths(like))}


_SHAPES = {}


def _shapes(arch):
    """(reference eval_shape params, port meta params), made once an arch."""
    if arch not in _SHAPES:
        jcfg = jax_config(arch)
        jmodel = jax_build(jcfg)
        _SHAPES[arch] = (jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0))),
                         build_model(get_config(arch), device="meta").param_tree())
    return _SHAPES[arch]


@pytest.mark.parametrize("strategy", ["tp", "dp"])
@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("arch", all_arch_ids())
def test_param_specs_equal_the_reference(arch, mesh, strategy):
    jshape, tshape = _shapes(arch)
    want = _jax_flat(jpart.param_specs(jshape, jax_config(arch), _abstract(MESHES[mesh]),
                                       strategy=strategy), jshape)
    got = _port_flat(tpart.param_specs(tshape, get_config(arch), MESHES[mesh],
                                       strategy=strategy), tshape)
    assert got == want


@pytest.mark.parametrize("arch,moments", [("deepseek_v3_671b", "int8"), ("olmo_1b", "float32")])
def test_opt_state_and_zero1_specs_equal_the_reference(arch, moments):
    jshape, tshape = _shapes(arch)
    jmesh = _abstract(POD)
    jos = jax.eval_shape(lambda: jopt.init_state(jshape, jopt.AdamWConfig(moment_dtype=moments)))
    tos = topt.init_state(tshape, topt.AdamWConfig(moment_dtype=moments))
    jp = jpart.param_specs(jshape, jax_config(arch), jmesh)
    tp = tpart.param_specs(tshape, get_config(arch), POD)
    for j, t in ((jpart.opt_state_specs(jos, jp), tpart.opt_state_specs(tos, tp)),
                 (jpart.zero1_moment_specs(jos, jmesh), tpart.zero1_moment_specs(tos, POD))):
        assert _port_flat(t, tos) == _jax_flat(j, jos)
    if moments == "int8":  # the deepseek embed's moment: 7168 / 16 = 448, 3.5 blocks a shard
        sp = tpart.opt_state_specs(tos, tp)["m"]["embed"]
        assert sp == {"q": ("model", "data"), "scale": ("model", None)}


@pytest.mark.parametrize("arch", all_arch_ids())
@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_param_specs_divide_evenly(arch, mesh):
    """Every spec evenly divides its dim (the port's mirror of
    ``tests/test_distributed.py::test_param_specs_divide_evenly``)."""
    _, tshape = _shapes(arch)
    m = MESHES[mesh]
    specs = tpart.param_specs(tshape, get_config(arch), m)
    for (path, sp), (_, leaf) in zip(tsteps._leaves_with_paths(specs),
                                     tsteps._leaves_with_paths(tshape)):
        assert len(sp) <= leaf.dim(), path
        for dim, axes in zip(leaf.shape, sp):
            assert dim % tsh.axis_size(m, axes) == 0, (path, sp, tuple(leaf.shape))


def test_big_params_actually_sharded():
    """The big matrices must not silently fall back to replicated (qwen's 40
    heads are padded to 48, so its attention splits 16 ways)."""
    _, tshape = _shapes("qwen2_5_14b")
    flat = dict(tsteps._leaves_with_paths(tpart.param_specs(tshape, get_config("qwen2_5_14b"),
                                                            POD)))
    assert flat["embed"] != (None, None)
    assert any(a is not None for a in flat["dense_layers/attn/wq"])
    assert any(a is not None for a in flat["dense_layers/ffn/w_up"])


def test_opt_state_specs_give_each_int8_moment_q_and_scale():
    _, tshape = _shapes("deepseek_v3_671b")
    tos = topt.init_state(tshape, topt.AdamWConfig(moment_dtype="int8"))
    specs = tpart.opt_state_specs(tos, tpart.param_specs(tshape, get_config("deepseek_v3_671b"),
                                                         POD))
    n_moments = sum(1 for _, x in tsteps._leaves_with_paths(tos["m"]))
    n_specs = len(tsteps._leaves_with_paths(specs["m"]))
    assert n_specs == n_moments
    quantized = [p for p, _ in tsteps._leaves_with_paths(specs["m"]) if p.endswith("/q")]
    assert len(quantized) == len([p for p, _ in tsteps._leaves_with_paths(specs["m"])
                                  if p.endswith("/scale")]) > 0
    assert specs["step"] == ()


@pytest.mark.parametrize("arch", all_arch_ids())
def test_batch_specs_equal_the_reference(arch):
    for multi_pod in (False, True):
        for shape in jshapes.SHAPES.values():
            want = {k: _norm(v, len(v)) for k, v in
                    jsteps.batch_specs(jax_config(arch), shape, multi_pod).items()}
            got = {k: _norm(v, len(v)) for k, v in tsteps.batch_specs(
                get_config(arch), tshapes.SHAPES[shape.name], multi_pod).items()}
            assert got == want, (shape.name, multi_pod)


@pytest.mark.parametrize("arch", all_arch_ids())
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_spec_tree_equals_the_reference(arch, shape):
    """Every leaf the reference's cache has gets its spec; the port's MLA
    cache also holds ``kv`` (the stack whose column views are ``latent`` and
    ``k_rope``), which takes theirs."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jshape = jshapes.SHAPES[shape]
    jmodel = jax_build(jcfg)
    jcache = jax.eval_shape(lambda: jmodel.empty_cache(jshape.batch, jshape.seq))
    meta = build_model(tcfg, device="meta")
    tcache = tshapes.cache_specs(meta, tcfg, tshapes.SHAPES[shape])
    for name, mesh in MESHES.items():
        multi = name == "multipod"
        want = _jax_flat(jsteps.cache_spec_tree(jcache, jshape, _abstract(mesh), multi), jcache)
        got = _port_flat(tsteps.cache_spec_tree(tcache, tshapes.SHAPES[shape], mesh, multi),
                         tcache)
        assert set(got) - set(want) <= {p for p in got if p.endswith("kv")}
        assert {p: got[p] for p in want} == want, name
        for p in set(got) - set(want):
            assert got[p] == got[p[:-2] + "latent"]


def test_rules_equal_the_reference():
    for multi_pod in (False, True):
        for strategy in ("tp", "dp"):
            assert tsh.train_rules(multi_pod, strategy) == jsh.train_rules(multi_pod, strategy)
        for kv in (False, True):
            assert tsh.decode_rules(multi_pod, shard_kv_seq=kv) == \
                jsh.decode_rules(multi_pod, shard_kv_seq=kv)


def test_spec_for_and_constrain_without_rules():
    x = torch.zeros(5, 4)
    assert tsh.constrain(x, "batch", "embed") is x  # no rules: a no-op
    rules = tsh.train_rules(False)
    with tsh.use_rules(rules):
        assert tsh.spec_for("batch", None, "heads", "vocab") == (("data",), None, "model",
                                                                   "model")
        with jsh.use_rules(jsh.train_rules(False)):
            assert _norm(jsh.spec_for("batch", "heads"), 2) == _norm(tsh.spec_for("batch",
                                                                               "heads"), 2)
        assert tsh.constrain(x, "batch", "embed") is x  # a plain tensor is left alone
        with pytest.raises(ValueError, match="2 names for rank-1"):
            tsh.constrain(torch.zeros(3), "batch", "embed")
    assert tsh.spec_for("batch") == (None,)


def test_placements_split_nested_axes_major_to_minor():
    """``("data", "model")`` on one dim is ``Shard(i)`` on both mesh dims,
    which DTensor cuts data first, then model: block ``d·M + m``."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 4)

    assert tsh.placements((("data", "model"), None), Mesh()) == [Shard(0), Shard(0)]
    assert tsh.placements((None, "model"), Mesh()) == [Replicate(), Shard(1)]
    assert tsh.placements(("pod", "data"), Mesh()) == [Shard(1), Replicate()]  # no pod axis
    assert tsh.placements((), Mesh(), rank=2) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="not in the mesh's order"):
        tsh.placements(((("model", "data")), None), Mesh())
    assert tsh.axis_size({"data": 2, "model": 4}, ("data", "model")) == 8
    assert tmesh.mesh_shape_dict({"data": 2}) == {"data": 2}


def test_shapes_and_cells_equal_the_reference():
    assert tshapes.SHAPES == {k: tshapes.ShapeSpec(**vars(v)) for k, v in jshapes.SHAPES.items()}
    assert tshapes.LONG_OK == jshapes.LONG_OK and tshapes.ENCDEC_TGT == jshapes.ENCDEC_TGT
    for arch in all_arch_ids():
        jcfg, tcfg = jax_config(arch), get_config(arch)
        assert [s.name for s in tshapes.all_cells(tcfg)] == \
            [s.name for s in jshapes.all_cells(jcfg)]
        for name, shape in tshapes.SHAPES.items():
            assert tshapes.cell_applicable(tcfg, shape) == \
                jshapes.cell_applicable(jcfg, jshapes.SHAPES[name])
            want = jshapes.input_specs(jcfg, jshapes.SHAPES[name])
            got = tshapes.input_specs(tcfg, shape)
            assert set(got) == set(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (arch, name, k)
                assert str(t.dtype).rsplit(".", 1)[-1] == str(np.dtype(want[k].dtype)), \
                    (arch, name, k)


def test_cache_specs_allocate_nothing():
    cfg = get_config("qwen2_5_14b")
    cache = tshapes.cache_specs(build_model(cfg, device="meta"), cfg, tshapes.SHAPES["decode_32k"])
    assert all(t.device.type == "meta" for _, t in tsteps._leaves_with_paths(cache))
    with pytest.raises(ValueError, match="meta device"):
        tshapes.cache_specs(build_model(cfg.reduced(), device="cpu"), cfg,
                            tshapes.SHAPES["decode_32k"])


def test_mesh_factories_need_a_process_group_of_their_size():
    with pytest.raises(RuntimeError, match="needs a process group of 256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
