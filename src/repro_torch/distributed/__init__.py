"""Distributed-runtime pieces of the port. Only the optimizer is ported so
far; the sharded steps and the data mesh are ROADMAP.md items 8 and 11."""
