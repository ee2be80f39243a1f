"""Checkpointing (the port of ``repro.checkpoint``)."""
from . import manager

__all__ = ["manager"]
