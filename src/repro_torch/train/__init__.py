"""The training loop (the port of ``repro.train``)."""
from . import trainer

__all__ = ["trainer"]
