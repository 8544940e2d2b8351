"""Distributed-runtime pieces of the port: the optimizer and the data mesh.

``data_mesh`` (DESIGN.md §15) is the data plane's view of the process
mesh: shard-ownership partitioning, the deterministic global shuffle, and
elastic membership. It stays numpy-only at import time; the torch-dependent
assembly helpers defer their import. The sharded steps are ROADMAP.md item
11.
"""

from typing import Any

__all__ = ["DataMesh"]


def __getattr__(name: str) -> Any:
    # lazy: most distributed users (the optimizer) never need the data
    # mesh, and data_mesh pulls in the fleet's hash ring
    if name == "DataMesh":
        from .data_mesh import DataMesh

        return DataMesh
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
