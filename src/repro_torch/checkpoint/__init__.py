"""Checkpoints as RawArray tensor stores, and the cold start that puts them
on the card."""

from .coldstart import (
    ColdStartStats,
    default_inflight_bytes,
    restore_naive,
    restore_pipelined,
    shardings_from_specs,
)
from .store import CheckpointManager, latest_step, load_checkpoint, save_checkpoint

__all__ = [
    "CheckpointManager",
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
    "restore_pipelined",
    "restore_naive",
    "ColdStartStats",
    "default_inflight_bytes",
    "shardings_from_specs",
]
