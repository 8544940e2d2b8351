"""Batched decode serving on RawArray checkpoints, on the card."""

from .engine import ServeEngine

__all__ = ["ServeEngine"]
