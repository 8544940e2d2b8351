"""The port (``src/repro_torch``) stands alone: it imports nothing of JAX or
of the JAX package ``repro``, and its copy of the on-disk format equals the
reference's, so the two copies cannot drift apart."""

import ast
import dataclasses
import os
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
        "mods = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "        or m == 'repro' or m.startswith('repro.')]\n"
        "print(','.join(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == ""


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
