"""The port (``src/repro_torch``, the examples' torch twins and
``chip_smoke.py``) stands alone: it imports nothing of JAX or of the JAX
package ``repro``, and its copy of the on-disk format equals the
reference's, so the two copies cannot drift apart."""

import ast
import dataclasses
import difflib
import os
import re
import struct
import subprocess
import sys

import pytest

import repro.core.layouts as ref_layouts
import repro.core.spec as ref_spec
import repro_torch.core.layouts as port_layouts
import repro_torch.core.spec as port_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "repro")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    examples = os.path.join(REPO, "examples")
    out += [os.path.join(examples, f) for f in sorted(os.listdir(examples))
            if f.endswith("_torch.py")]  # the examples' torch twins
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py")]
    return out


def _guarded_by_import_error(node, parents):
    """True when ``node`` sits in the body of a ``try`` that catches ImportError."""
    for p in parents:
        if isinstance(p, ast.Try) and any(
            isinstance(h.type, ast.Name) and h.type.id in ("ImportError", "ModuleNotFoundError")
            for h in p.handlers
        ) and any(node is n for stmt in p.body for n in ast.walk(stmt)):
            return True
    return False


def _imports(path):
    """(top-level module name, line, guarded) for every absolute import."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    parents = {}
    for p in ast.walk(tree):
        for c in ast.iter_child_nodes(p):
            parents[c] = p

    def chain(n):
        while n in parents:
            n = parents[n]
            yield n

    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        for name in names:
            yield name.split(".")[0], node.lineno, _guarded_by_import_error(node, chain(node))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = []
    for top, line, guarded in _imports(path):
        if top in FORBIDDEN:
            bad.append(f"line {line}: {top}")
        # ml_dtypes is optional: only an ImportError-guarded probe (core/dtypes.py,
        # for bfloat16 .ra files) may name it, and nothing may require it
        if top == "ml_dtypes" and not guarded:
            bad.append(f"line {line}: unguarded ml_dtypes")
    assert bad == []


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.data, repro_torch.kernels.ops\n"
        "import repro_torch.data.device_loader, repro_torch.kernels._build\n"
        "import repro_torch.models, repro_torch.models.convert, repro_torch.configs\n"
        "import repro_torch.models.ssm_lm, repro_torch.models.whisper\n"
        "import repro_torch.kernels.ssd_scan\n"
        "import repro_torch.checkpoint, repro_torch.serving, repro_torch.serving.__main__\n"
        "import repro_torch.remote, repro_torch.fleet, repro_torch.formats\n"
        "import repro_torch.core.racat, repro_torch.devtools.tsan, repro_torch.devtools.doctor\n"
        "import repro_torch.distributed.data_mesh, repro_torch.launch.train\n"
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "        or m == 'repro' or m.startswith('repro.')]\n"
        "print(','.join(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_the_url_plane_loads_no_torch():
    """``racat header`` and the byte-range server stay as light as the JAX
    package's: the remote plane, the fleet and the formats import no torch."""
    code = (
        "import sys\n"
        "import repro_torch.remote, repro_torch.fleet, repro_torch.formats\n"
        "import repro_torch.core.racat, repro_torch.devtools.doctor\n"
        "import repro_torch.distributed.data_mesh\n"
        "print([m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro')])\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


#: modules the port carries as copies of the JAX package's, and where each
#: may differ from the reference's text once ``repro`` reads ``repro_torch``:
#: ``-`` the reference's line numbers (the reference does not change), ``+``
#: the port's lines that stand in for them; ``block`` a rewritten span, the
#: reference's lines ``first..last`` standing against the port's lines from
#: the one that reads ``start`` to the next that reads ``end``
COPIES = {
    **{f"{pkg}/{mod}.py": {} for pkg, mods in (
        ("remote", ("__init__", "cache", "client", "server")),
        ("fleet", ("__init__", "_proxy", "loadgen")),
        ("formats", ("__init__", "hdf5min", "ingest", "npy", "nrrd", "png")),
    ) for mod in mods},
    "devtools/doctor.py": {},
    "core/sharded.py": {},
    # comments that named the reference project's change numbers say what
    # they meant instead
    "fleet/edge.py": {
        "-": [6],
        "+": ["hierarchy: the remote plane's block LRU in RAM (``RA_FLEET_CACHE_MB``), a"],
    },
    "fleet/router.py": {
        "-": [438],
        "+": ["# shape once fixed in the loader ring. _stop.set() wakes the"],
    },
    "core/io.py": {
        # the stored element kind of bfloat16 bits held as uint16 (the
        # checkpoint store's bf16 leaves, local and over a URL)
        "-": [132],
        "+": ["import dataclasses", "eltype: Optional[int] = None,", "",
              "``eltype`` overrides the header's element kind for the bits ``arr``",
              "holds: ``ELTYPE_BRAIN`` stores bfloat16 patterns held as uint16, so the",
              "file names bfloat16 without ``ml_dtypes``.",
              "True)`` — or the on-device CUDA kernel — reconstructs the logical",
              "if eltype is not None:", "hdr = dataclasses.replace(hdr, eltype=eltype)"],
    },
    "data/dataset.py": {
        "-": [80],
        "+": ["(``DeviceLoader`` via the CUDA dequant kernel). ``spec`` is ``\"u8\"``"],
    },
    "core/racat.py": {
        "-": [344],
        "+": ["\"no rastats block (written before rastats existed, or with stats=False); \""],
    },
    "data/loader.py": {
        "-": [40],
        "+": ["there with the CUDA dequant kernel."],
    },
    # global assembly builds DTensors over a DeviceMesh instead of jax.Arrays
    "distributed/data_mesh.py": {
        "-": [38, 39],
        "+": ["``DTensor``s (``Shard(0)`` over a 1-D ``DeviceMesh`` of the process group,",
              "one process per card) via ``DTensor.from_local``, the counterpart of the",
              "JAX package's ``jax.make_array_from_single_device_arrays``."],
        "block": (393, 457, "# global assembly (torch deferred: the mesh schedule itself is numpy)",
                  "    return out"),
    },
    "devtools/tsan.py": {
        # ralint's scanner is devtools/guards.py here; no pytest plugin
        "-": [3, 20, 29, 33, 425, 439],
        "+": ["Two instruments, installed by a caller (:func:`install`, :func:`watch_all`;",
              "the JAX package's copy is also activated under pytest with",
              "``--ra-sanitize``):",
              "protected object dead (:meth:`finalize`); the loader ring's old zombie writer",
              "field (maps come from ``repro_torch.devtools.guards``' comment scanner via",
              "error is recorded.  The block cache's old counter race (``cache.hits += 1``",
              "from .guards import collect_guards",
              "#: the threaded modules of this package that :func:`watch_all` traces"],
    },
}


def _renamed_reference(rel):
    with open(os.path.join(REPO, "src", "repro", rel), encoding="utf-8") as f:
        return re.sub(r"\brepro\b", "repro_torch", f.read())


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_matches_reference(rel):
    """Each copy equals its reference after the package rename, but where
    ``COPIES`` says: the copies cannot drift silently."""
    with open(os.path.join(PORT, rel), encoding="utf-8") as f:
        port = f.read().splitlines()
    ref = _renamed_reference(rel).splitlines()
    allowed = COPIES[rel]
    numbers = list(range(1, len(ref) + 1))  # the reference's line numbers
    if "block" in allowed:
        first, last, start, end = allowed["block"]
        j0 = port.index(start)
        j1 = port.index(end, j0)
        ref, numbers = ref[:first - 1] + ref[last:], numbers[:first - 1] + numbers[last:]
        port = port[:j0] + port[j1 + 1:]
    removed, added = [], []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, ref, port,
                                                       autojunk=False).get_opcodes():
        if tag in ("replace", "delete"):
            removed += numbers[i1:i2]
        if tag in ("replace", "insert"):
            added += [line.strip() for line in port[j1:j2]]
    assert removed == allowed.get("-", []), rel
    assert sorted(added) == sorted(allowed.get("+", [])), rel


def test_guard_scanner_is_ralints():
    """``devtools/guards.py`` holds ralint's ``# guarded-by:`` scanner as the
    JAX package's ``devtools/lint.py`` defines it, definition for definition."""
    def defs(path):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        out = {}
        for node in ast.parse(src).body:
            if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
                out[node.name] = ast.get_source_segment(src, node)
            elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
                out[node.targets[0].id] = ast.get_source_segment(src, node)
        return out

    port = defs(os.path.join(PORT, "devtools", "guards.py"))
    ref = defs(os.path.join(REPO, "src", "repro", "devtools", "lint.py"))
    assert set(port) == {"GUARDED_RE", "ALLOW_RE", "FileInfo", "_collect_guards",
                         "collect_guards"}
    for name, text in port.items():
        assert text == ref[name], name


def _geometry(layout):
    d = dataclasses.asdict(layout)
    d.pop("module")  # names the declaring module of each package
    return d


def test_layout_registry_matches_reference():
    assert set(port_layouts.LAYOUTS) == set(ref_layouts.LAYOUTS)
    for name, lay in ref_layouts.LAYOUTS.items():
        assert _geometry(port_layouts.LAYOUTS[name]) == _geometry(lay), name
    assert port_layouts.REGISTERED_FORMATS == ref_layouts.REGISTERED_FORMATS


def _value(v):
    """A constant as comparable data (a ``struct.Struct`` by its format)."""
    if isinstance(v, struct.Struct):
        return ("struct", v.format)
    if dataclasses.is_dataclass(v):
        return _geometry(v)
    return v


def test_spec_constants_match_reference():
    ref_consts = {k: v for k, v in vars(ref_spec).items() if k.isupper()}
    port_consts = {k: v for k, v in vars(port_spec).items() if k.isupper()}
    assert ref_consts and port_consts.keys() == ref_consts.keys()
    for k, v in ref_consts.items():
        assert _value(port_consts[k]) == _value(v), k


def test_cuda_source_ships_with_the_package():
    from repro_torch.kernels import _build

    for source in _build.SOURCES:
        assert os.path.isfile(os.path.join(PORT, "kernels", "csrc", source))
    with open(os.path.join(REPO, "pyproject.toml"), encoding="utf-8") as f:
        assert 'repro_torch = ["kernels/csrc/*.cu"]' in f.read()
    # the build lands in the repository's build/ directory, which git ignores
    assert os.path.relpath(_build.BUILD_DIR, REPO) == os.path.join("build", "repro_torch")
