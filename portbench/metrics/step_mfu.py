"""Model FLOPs of the window's work (the family reference's
``token_flops`` over every prompt and decoded token) over the window's
seconds times the bf16 peak (%)."""


def read(w):
    return w.mfu_pct()
