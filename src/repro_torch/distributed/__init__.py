"""Distributed runtime of the port: the optimizer, the data mesh, the
sharding rules and partition specs, the expert-parallel MoE, the Megatron
split of the serve steps with context-parallel decode, and the sharded
train / prefill / decode steps (``sharding``, ``partition``, ``moe_ep``,
``tensor_parallel``, ``steps``; ``DeviceMesh``/``DTensor`` code whose spec
tables are the JAX package's). The serve steps of the dense, vlm, moe, ssm
and hybrid families and the ``tp`` train step of the dense, vlm and moe
families run the Megatron split; the ssm and hybrid families' training split
and the encdec family's split are ROADMAP.md item 18.

``data_mesh`` (DESIGN.md §15) is the data plane's view of the process
mesh: shard-ownership partitioning, the deterministic global shuffle, and
elastic membership. It stays numpy-only at import time; the torch-dependent
assembly helpers defer their import.
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
