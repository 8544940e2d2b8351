"""Build the package's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` has a plain C entry point and no PyTorch headers,
so one ``nvcc`` call takes seconds. Libraries go to ``build/repro_torch/`` at
the repository root, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags: an edited source or header builds anew, an
unchanged one is loaded from disk. Nothing here runs
at import; the first call of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Sequence

from ..core.spec import RawArrayError

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = (
    "dequant_u8.cu", "flash_attention.cu", "flash_attention_bwd.cu", "decode_attention.cu",
    "ssd_scan.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
_fns: Dict[str, Any] = {}  # guarded-by: _lock


def nvcc() -> str:
    """Path of ``nvcc``: ``PATH`` first, then the toolkit's usual homes."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RawArrayError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def lib_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: named by the
    source, every header under ``csrc/`` (a source may include any of them)
    and the flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` per source,
    all started together. Returns each compiled source's compiler log (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in sources:
        out = lib_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((source, out, tmp, proc))
    logs: Dict[str, str] = {}
    failed = []
    for source, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[source] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RawArrayError("\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if missing."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = lib_path(source)
            if not path.exists():
                build((source,))
            lib = ctypes.CDLL(str(path))
            _libs[source] = lib
        return lib


def function(source: str, symbol: str, argtypes: Sequence[Any]) -> Any:
    """The C entry point ``symbol`` of ``csrc/<source>`` with its argument
    types set and an ``int`` (``cudaError_t``) result; built and loaded at
    its first call."""
    lib = load(source)
    with _lock:
        fn = _fns.get(symbol)
        if fn is None:
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
        return fn
