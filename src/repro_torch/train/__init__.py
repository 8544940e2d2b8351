"""Fault-tolerant training loop."""

from .loop import TrainLoopConfig, train

__all__ = ["train", "TrainLoopConfig"]
