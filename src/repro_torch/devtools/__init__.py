"""Correctness tooling for the threaded data plane (DESIGN.md §17).

Two tools of the JAX package's three:

* ``repro_torch.devtools.tsan`` — a runtime concurrency sanitizer: drop-in
  instrumented ``Lock``/``RLock``/``Condition`` recording a global
  acquisition graph (lock-order inversions, long holds,
  acquire-after-finalize) plus a guarded-field write tracer that flags
  unguarded cross-thread mutation (:func:`tsan.watch_all` watches this
  package's threaded modules).
* ``repro_torch.devtools.doctor`` — checks real ``.ra`` files against the
  layout registry (``racat doctor FILE|DIR``), nonzero exit on drift.

The third, the *ralint* linter, is not part of this package: ``python
tools/ralint.py src/`` lints both packages' sources.

Import is lazy so ``repro_torch.core`` never pays for devtools.
"""

from __future__ import annotations

__all__ = ["tsan", "doctor"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
