"""Tokens completed in the window over its seconds: prompt tokens whose
prefill finished inside it and output tokens that reached the host inside
it."""


def read(w):
    return w.tok_s()
