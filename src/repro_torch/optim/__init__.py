"""Optimizers: AdamW with an fp32 master copy, and gradient compression
(the port of ``repro.optim``)."""
from . import adamw, compress
from .adamw import (AdamWConfig, AdamWState, global_norm, init, schedule,
                    update)

__all__ = ["adamw", "compress", "AdamWConfig", "AdamWState", "init",
           "update", "schedule", "global_norm"]
