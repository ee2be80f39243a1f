"""The decode_attn kernel's share of its roofline over the traced stretch (%):
``roofline/decode_attn.py``'s bound summed over its calls, over its device time."""


def read(w):
    return w.roofline_pct("decode_attn")
