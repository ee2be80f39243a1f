"""The temporal-vectorization IR: the port's own copies of the reference's
numpy-only ``core`` modules (``symbolic``, ``ir``, ``streaming``,
``multipump``), plus ``pump_plan`` with Hopper constants in place of the
reference's TPU ones."""
