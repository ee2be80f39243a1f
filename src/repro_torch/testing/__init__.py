"""``repro_torch.testing`` — test-only infrastructure shipped with the
port, the port of ``repro.testing``.

:mod:`.faults` is the deterministic fault-injection harness the chaos
suite (``tests/test_torch_chaos.py``) and ``chip_smoke.py``'s robustness
phase drive; the port threads named injection sites through the
compile→serve path and this package decides — by seeded rule — whether a
site fires.  With no rules installed every site is a single falsy
attribute check.
"""
from . import faults

__all__ = ["faults"]
