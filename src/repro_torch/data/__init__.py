"""The data stream (the port of ``repro.data``)."""
from . import pipeline

__all__ = ["pipeline"]
