"""Baseline formats the paper benchmarks against, implemented in-tree.

The evaluation container is offline (no h5py / libpng / pynrrd), and the
system prompt's rule is: *if the paper compares against a baseline,
implement the baseline too*. So:

* :mod:`repro_torch.formats.hdf5min` — a minimal but structurally faithful HDF5
  writer/reader (superblock v0, B-tree v1 group node, local heap, SNOD,
  v1 object headers, contiguous layout).
* :mod:`repro_torch.formats.png`     — a complete PNG codec on stdlib zlib
  (IHDR/IDAT/IEND, all five filter types on decode).
* :mod:`repro_torch.formats.nrrd`    — NRRD text-header + raw payload.
* :mod:`repro_torch.formats.npy`     — thin wrapper over numpy's own .npy.
* :mod:`repro_torch.formats.ingest`  — foreign-format → RawArray dataset
  converters streaming through the ingest plane (DESIGN.md §11).
"""

from . import hdf5min, ingest, npy, nrrd, png  # noqa: F401
