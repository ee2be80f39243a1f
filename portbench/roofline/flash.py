"""Flash attention (``csrc/flash_attention.cu``), causal, on a fresh
prefill: per call the least work is q.k and p.v over each query's keys
0..i, 4 D FLOPs a key and head, and q, k, v read and o written once, bf16
on the tensor cores."""
from collections import Counter

PATTERN = r"flash_fwd_(bf16|fp32)"
COUNTER = "flash_attention"


def applications(port):
    every = port.get("hybrid_attn_every") or 0
    return port["n_layers"] // every if every else port["n_layers"]


def calls(port, steps):
    h, hkv = port["n_heads"], port["n_kv_heads"]
    hd = port.get("head_dim") or port["d_model"] // h
    n = applications(port)
    out = []
    for s in steps:
        for plen, g in Counter(s.prefills).items():
            flops = 2.0 * g * h * hd * plen * (plen + 1)
            nbytes = 2.0 * g * plen * hd * (2 * h + 2 * hkv)
            out.append((n, flops, nbytes, "bf16_flops"))
    return out
