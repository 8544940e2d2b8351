"""Checkpoints on the RawArray format, over nested dicts of tensors.

The torch twin of the JAX package's ``checkpoint/store.py``, with its on-disk
layout unchanged, so a checkpoint written by either package restores in the
other bit for bit::

    step_000420/
      manifest.json        leaf -> file, dtypes/shapes, quant schemas, extra
      param__embed.ra      one RawArray file per leaf
      param__dense_layers__attn__wq.ra
      ...

* leaf names join the dict keys of the leaf's path with ``__`` under a
  ``param``/``opt`` prefix, keys in sorted order (the JAX pytree order);
* **atomic publish**: leaves and the manifest land in ``<dir>.tmp``, which
  is renamed once complete;
* ``http(s)://`` checkpoint directories (DESIGN.md §9, §11): a restore
  fetches the manifest over HTTP and streams every leaf by ranged reads in
  the same one-wave plan as a local restore; a save ships each leaf as one
  authenticated atomic PUT and uploads the manifest last, so a remote
  checkpoint becomes visible only once complete;
* ``quantize="u8"`` stores float16/32/64 leaves as uint8 codes with
  per-channel calibration (bfloat16 leaves verbatim, as the JAX package
  does); the schema rides in the manifest and in each leaf's metadata,
  ``orig_dtype`` naming the logical dtype;
* bfloat16 leaves need no ``ml_dtypes``: their 16-bit patterns are written
  and read as such, and the header names them ``ELTYPE_BRAIN`` as the JAX
  package writes them.

Restores read every leaf in one engine wave (slab reads and chunk decodes
share the pool). ``CheckpointManager`` drives saves for a train loop: one
asynchronous save in flight at a time, leaves snapshotted to host memory
before ``save`` returns, keep-last-k garbage collection (local directories
only: remote stores collect server-side). ``restore_resharded`` reads one
leaf's row slice, locally or by ranged reads.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import core as ra
from ..core.spec import ELTYPE_BRAIN, ELTYPE_UINT, RawArrayError
from ..data.device_loader import torch_dtype
from ..kernels import ref

MANIFEST = "manifest.json"
_SEP = "__"
#: leaf dtypes ``quantize`` turns into codes: numpy's floating types
_QUANTIZED = (torch.float16, torch.float32, torch.float64)

_join = ra.join_path


def _load_manifest(path: str) -> Dict[str, Any]:
    if ra.is_url(path):
        from .. import remote

        return json.loads(remote.fetch_bytes(_join(path, MANIFEST)))
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


# ------------------------------------------------------------------ trees
def flatten(tree: Any, prefix: str) -> Dict[str, Any]:
    """``{leaf name: leaf}`` in the JAX pytree order (dict keys sorted)."""
    out: Dict[str, Any] = {}

    def walk(node: Any, keys: Tuple[str, ...]) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], keys + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, keys + (str(i),))
        else:
            out[prefix + _SEP + _SEP.join(keys) if keys else prefix] = node

    walk(tree, ())
    return out


def unflatten(like: Any, prefix: str, leaves: Dict[str, Any]) -> Any:
    """``like``'s structure with each leaf replaced by ``leaves[name]``."""
    def walk(node: Any, keys: Tuple[str, ...]) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, keys + (str(i),)) for i, v in enumerate(node))
        return leaves[prefix + _SEP + _SEP.join(keys) if keys else prefix]

    return walk(like, ())


def dtype_name(t: torch.Tensor) -> str:
    """numpy's name for a tensor's dtype (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(t.dtype).rsplit(".", 1)[-1]


def numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


# ------------------------------------------------------------------ save
def _as_host(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, np.ndarray):
        from ..models.convert import tensor_from_numpy

        return tensor_from_numpy(leaf)
    return leaf.detach().to("cpu").contiguous()


def _host_array(t: torch.Tensor) -> np.ndarray:
    """The numpy array ``ra.write`` stores: bfloat16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(
    directory: str,
    step: int,
    params: Any,
    opt_state: Any = None,
    *,
    extra: Optional[Dict[str, Any]] = None,
    crc32: bool = False,
    chunked: bool = False,
    codec: Optional[str] = None,
    chunk_bytes: Optional[int] = None,
    quantize: Optional[str] = None,
) -> str:
    """Synchronous atomic save of nested dicts of tensors (on any device;
    numpy arrays are taken too). Returns the final checkpoint path.

    ``quantize="u8"`` stores every float16/32/64 leaf of rank >= 1 as uint8
    codes, calibrated per channel of the last axis, with ``orig_dtype`` the
    leaf's own dtype. bfloat16 leaves are stored verbatim, as the JAX
    package's writer stores them (numpy does not count ``ml_dtypes.bfloat16``
    as floating), so both packages write the same files.

    ``directory`` may be an ``http(s)://`` URL of a write-enabled byte-range
    server: every leaf ships as one authenticated PUT with server-side
    atomic publish (token knob ``RA_REMOTE_TOKEN``), and the manifest is
    uploaded last, so the checkpoint does not exist remotely until the final
    PUT lands."""
    remote_save = ra.is_url(directory)
    final = _join(directory, f"step_{step:08d}")
    if remote_save:
        tmp = final  # leaf PUTs are individually atomic; manifest-last publishes
    else:
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)

    leaves: Dict[str, Any] = flatten(params, "param")
    if opt_state is not None:
        leaves.update(flatten(opt_state, "opt"))
    manifest: Dict[str, Any] = {
        "format": "rawarray-checkpoint-v1",
        "step": step,
        "leaves": {},
        "extra": extra or {},
        "time": time.time(),
    }
    write_tasks: List[Callable[[], None]] = []
    for name, leaf in leaves.items():
        t = _as_host(leaf)
        fname = name + ".ra"
        fpath = _join(tmp, fname)
        entry: Dict[str, Any] = {"file": fname, "shape": list(t.shape), "dtype": dtype_name(t)}
        meta: Optional[bytes] = None
        brain = t.dtype == torch.bfloat16
        if quantize is not None and t.dtype in _QUANTIZED and t.dim() >= 1:
            arr = t.numpy()
            info = ra.quant.quant_params(arr, quantize)
            arr = info.quantize(arr)
            meta = info.encode()
            entry["quant"] = info.to_dict()
            entry["stored_dtype"] = str(arr.dtype)
        else:
            arr = _host_array(t)

        write_tasks.append(
            lambda p=fpath, a=arr, m=meta, b=brain: ra.write(
                p, a, metadata=m, crc32=crc32, chunked=chunked, codec=codec,
                chunk_bytes=chunk_bytes, eltype=ELTYPE_BRAIN if b else None,
            )
        )
        manifest["leaves"][name] = entry
    ra.engine.run_tasks(write_tasks)
    body = json.dumps(manifest, indent=1).encode()
    if remote_save:
        from .. import remote

        remote.upload_bytes(_join(final, MANIFEST), body)  # publish: manifest LAST
        return final
    with open(os.path.join(tmp, MANIFEST), "wb") as f:
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


# ------------------------------------------------------------------ read
def stored_dtype(hdr) -> torch.dtype:
    """The torch dtype of a leaf file's stored elements."""
    if hdr.eltype == ELTYPE_BRAIN and hdr.elbyte == 2:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, hdr.dtype().newbyteorder("="))).dtype


def _entry_quant(entry: Dict[str, Any], fpath: str, hdr) -> Optional["ra.quant.QuantInfo"]:
    """The leaf's dequantization schema, or None for a verbatim leaf: from
    the manifest, else from the file's metadata when a float leaf is stored
    as uint8 codes by another writer."""
    q = entry.get("quant")
    if q is not None:
        return ra.quant.QuantInfo.from_dict(q)
    want = entry.get("dtype")
    if (hdr.eltype, hdr.elbyte) == (ELTYPE_UINT, 1) and want not in (None, "uint8", "void"):
        return ra.read_quant_metadata(fpath)
    return None


def _read_whole(fpath: str, hdr, mv: memoryview) -> None:
    """Payload of a file the slab and chunk readers do not take (a CRC
    trailer, whole-file zlib, big-endian), checked and converted to native
    byte order, into ``mv``."""
    if ra.is_url(fpath):
        from .. import remote

        blob = remote.fetch_bytes(fpath)
    else:
        with open(fpath, "rb") as f:
            blob = f.read()
    payload = blob[hdr.nbytes: hdr.nbytes + hdr.data_length]
    if len(payload) != hdr.data_length:
        raise RawArrayError(f"{fpath}: truncated data segment")
    if hdr.flags & ra.FLAG_CRC32_TRAILER:
        if len(blob) < hdr.nbytes + hdr.data_length + 4:
            raise RawArrayError(f"{fpath}: CRC flag set but trailer missing")
        if zlib.crc32(payload) != int.from_bytes(blob[-4:], "little"):
            raise RawArrayError(f"{fpath}: CRC32 mismatch: data segment corrupted")
    if hdr.flags & ra.FLAG_ZLIB:
        payload = zlib.decompress(payload)
    if len(payload) != hdr.logical_nbytes:
        raise RawArrayError(f"{fpath}: payload is {len(payload)} bytes, header wants "
                            f"{hdr.logical_nbytes}")
    if hdr.big_endian and hdr.elbyte > 1:
        wire = np.dtype(">u2") if hdr.eltype == ELTYPE_BRAIN else hdr.dtype()
        payload = np.frombuffer(payload, wire).astype(wire.newbyteorder("=")).tobytes()
    mv[:] = payload


def _byte_view(t: torch.Tensor) -> memoryview:
    """A writable byte view of a contiguous CPU tensor's storage."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy()).cast("B")


@dataclass
class Leaf:
    """One leaf file on its way in: resolved header, chunk table and quant
    schema, and the engine tasks that fill a host buffer with its payload.
    ``src`` is what the reads go through: a held fd for a local file, the
    pooled ``RemoteReader`` for a URL."""

    name: str
    fpath: str
    entry: Dict[str, Any]
    src: Any = None                # int fd or RemoteReader
    fd: Optional[int] = None       # owned; the caller closes it
    hdr: Any = None
    table: Any = None
    quant: Any = None

    def open(self) -> None:
        if ra.is_url(self.fpath):
            from .. import remote

            self.src = remote.get_reader(self.fpath)
        else:
            self.fd = self.src = os.open(self.fpath, os.O_RDONLY)

    def close(self) -> None:
        if self.fd is not None:
            try:
                os.close(self.fd)
            except OSError:
                pass
            self.fd = None
        self.src = None

    def resolve(self, want: Optional[Tuple[int, ...]] = None) -> None:
        if self.src is None:
            self.open()
        if ra.is_url(self.fpath):
            # a pooled ranged read instead of header_of's own connection; the
            # block cache keeps the fetched prefix for the payload reads
            head = self.src.read_range(0, min(self.src.size, 4096))
            hdr = self.hdr = ra.decode_header(head)
        else:
            hdr = self.hdr = ra.header_of(self.fpath)
        if want is not None and tuple(hdr.shape) != want:
            raise ValueError(f"{self.name}: checkpoint {tuple(hdr.shape)} vs model {want}")
        if hdr.flags & ra.FLAG_CHUNKED and not hdr.big_endian and hdr.data_length:
            self.table = ra.codec.read_table(self.src, hdr)
        self.quant = _entry_quant(self.entry, self.fpath, hdr)

    def buffer(self, pin: bool = False) -> torch.Tensor:
        return torch.empty(self.hdr.shape, dtype=stored_dtype(self.hdr), pin_memory=pin)

    def tasks(self, buf: torch.Tensor) -> List[Callable[[], None]]:
        """Engine tasks that fill ``buf`` with the stored payload."""
        hdr = self.hdr
        if not hdr.logical_nbytes:
            return []
        mv = _byte_view(buf)
        if self.table is not None:
            return ra.codec.chunk_read_tasks(self.src, hdr, self.table, 0, hdr.logical_nbytes, mv)
        if hdr.plain:
            return ra.engine.span_read_tasks([(self.src, hdr.nbytes, mv)])
        return [lambda: _read_whole(self.fpath, hdr, mv)]


def dequant_host(codes: torch.Tensor, quant) -> torch.Tensor:
    """uint8 codes -> logical values on the host: the kernel's plain version
    (f32 multiply, then add, then one rounding), as numpy's decode."""
    c = int(codes.shape[-1]) if codes.dim() else 1
    scale, bias = (torch.from_numpy(a) for a in quant.channel_params(c))
    out = ref.dequant_u8_ref(codes.reshape(-1, c), scale, bias, torch_dtype(quant.orig_dtype))
    return out.reshape(codes.shape)


def _read_leaves_parallel(
    path: str,
    manifest: Dict[str, Any],
    names: List[str],
    quants_out: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Stream many leaf files into host tensors in ONE engine wave. Quantized
    leaves are decoded on the host afterwards, unless the caller passes
    ``quants_out``, which then receives each quantized leaf's ``QuantInfo``
    and the stored codes stay as they are."""
    leaves = [Leaf(n, _join(path, manifest["leaves"][n]["file"]), manifest["leaves"][n])
              for n in names]
    try:
        ra.engine.run_tasks([leaf.resolve for leaf in leaves])
        out = {leaf.name: leaf.buffer() for leaf in leaves}
        tasks: List[Callable[[], None]] = []
        for leaf in leaves:
            tasks += leaf.tasks(out[leaf.name])
        ra.engine.run_tasks(tasks)
    finally:
        for leaf in leaves:
            leaf.close()
    quants = {leaf.name: leaf.quant for leaf in leaves if leaf.quant is not None}
    if quants_out is not None:
        quants_out.update(quants)
    else:
        for name, q in quants.items():
            out[name] = dequant_host(out[name], q)
    return out


def load_checkpoint(
    path: str,
    params_like: Any,
    opt_like: Any = None,
) -> Tuple[Any, Any, Dict[str, Any]]:
    """Restore into the structure of ``params_like`` (a nested dict whose
    leaves have ``.shape``: tensors, numpy arrays, meta tensors). Leaves come
    back as CPU tensors, quantized ones decoded to their ``orig_dtype``.
    ``path`` may be an ``http(s)://`` checkpoint URL: the same wave plan
    over ranged reads."""
    manifest = _load_manifest(path)

    def restore(tree: Any, prefix: str) -> Any:
        flat = flatten(tree, prefix)
        arrays = _read_leaves_parallel(path, manifest, list(flat))
        for name, like in flat.items():
            got, want = tuple(arrays[name].shape), tuple(like.shape)
            if got != want:
                raise ValueError(f"{name}: checkpoint {got} vs model {want}")
        return unflatten(tree, prefix, arrays)

    params = restore(params_like, "param")
    opt = restore(opt_like, "opt") if opt_like is not None else None
    return params, opt, manifest.get("extra", {})


def restore_resharded(
    path: str,
    name: str,
    *,
    row_start: int,
    row_stop: int,
    dequantize: bool = False,
) -> torch.Tensor:
    """Elastic restore: rows [start, stop) of one leaf as a CPU tensor —
    offset arithmetic on the .ra file, no full-array read. Works on a
    checkpoint URL too (the row slab becomes ranged requests) and on
    chunked-compressed leaves (only the chunks overlapping the slab are
    fetched and decoded).

    ``dequantize=True`` reconstructs logical floats from a quantized-u8
    leaf; row slicing composes with the quant schema because calibration is
    per-channel over the last axis (every row carries all channels)."""
    manifest = _load_manifest(path)
    entry = manifest["leaves"][name]
    leaf = Leaf(name, _join(path, entry["file"]), entry)
    hdr = ra.header_of(leaf.fpath)
    quant = _entry_quant(entry, leaf.fpath, hdr) if dequantize else None
    chunked = bool(hdr.flags & ra.FLAG_CHUNKED)
    if hdr.compressed and not chunked:
        raise RawArrayError("cannot row-slice a whole-file-compressed payload; "
                            "save the checkpoint with chunked=True")
    if not hdr.shape:
        raise RawArrayError("cannot row-slice a 0-d array")
    n = hdr.shape[0]
    row_start, row_stop = max(0, row_start), min(row_stop, n)
    if row_stop < row_start:
        raise RawArrayError(f"bad slice [{row_start}, {row_stop})")
    row = hdr.elbyte * numel(hdr.shape[1:])
    out = torch.empty((row_stop - row_start,) + tuple(hdr.shape[1:]), dtype=stored_dtype(hdr))
    if out.numel():
        leaf.open()
        try:
            mv = _byte_view(out)
            if chunked:
                table = ra.codec.read_table(leaf.src, hdr)
                ra.engine.run_tasks(ra.codec.chunk_read_tasks(
                    leaf.src, hdr, table, row_start * row, row_stop * row, mv))
            else:
                ra.engine.parallel_read_into(leaf.src, hdr.nbytes + row_start * row, mv)
        finally:
            leaf.close()
        if hdr.big_endian and hdr.elbyte > 1:
            wire = hdr.dtype()
            out = torch.from_numpy(
                np.frombuffer(mv, wire).astype(wire.newbyteorder("=")).reshape(out.shape))
    return dequant_host(out, quant) if quant is not None else out


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None


def _snapshot(tree: Any) -> Any:
    """A host copy of every leaf of nested dicts of tensors: a CPU leaf is
    cloned, since the trainer updates its parameters in place."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    t = tree.detach()
    return t.clone() if t.device.type == "cpu" else t.to("cpu")


class CheckpointManager:
    """Async, keep-last-k checkpoint driver for the training loop (the JAX
    package's ``CheckpointManager``, which also passes chunking, codec and
    quantization options through to the store; no caller of either package
    sets them, and the port leaves them out). ``save`` waits for the save before it,
    copies every leaf to host memory, and writes them on a background thread
    while training goes on; ``wait`` joins that thread and re-raises what it
    raised. ``save_s`` sums the seconds the writes took."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        # the save thread adds to save_s and may leave an error; the trainer
        # reads both after wait()
        self._lock = threading.Lock()
        self.save_s = 0.0  # guarded-by: _lock
        self._error: Optional[BaseException] = None  # guarded-by: _lock
        if not ra.is_url(directory):
            os.makedirs(directory, exist_ok=True)

    def wait(self) -> None:
        """Block until the save in flight (if any) is on disk; re-raise its
        error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def save(self, step: int, params: Any, opt_state: Any = None,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()  # one in flight at a time
        # snapshot to host before returning: the parameters change at the next step
        host_params, host_opt = _snapshot(params), _snapshot(opt_state)

        def run() -> None:
            t0 = time.perf_counter()
            try:
                save_checkpoint(self.directory, step, host_params, host_opt, extra=extra)
                self._gc()
            except Exception as e:  # handed to the trainer by wait()
                with self._lock:
                    self._error = e
            with self._lock:
                self.save_s += time.perf_counter() - t0

        self._thread = threading.Thread(target=run, daemon=False, name="ra-ckpt")
        self._thread.start()

    def _gc(self) -> None:
        if ra.is_url(self.directory):
            return  # remote stores garbage-collect server-side, not from here
        steps = sorted(
            int(d[5:])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")
