"""Fault-tolerance runtime (the port of ``repro.runtime``)."""
from . import failover

__all__ = ["failover"]
