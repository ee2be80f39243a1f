"""Decode attention (``csrc/decode_attention.cu``) of one scheduler step:
each lane's query against its keys 0..pos in the fp32 cache.  Per call
the least work is 4 D FLOPs a key and head, and each lane's keys and
values read once, its bf16 query read and output written once."""
PATTERN = r"decode_split"
COUNTER = "decode_attention"


def calls(port, steps):
    h, hkv = port["n_heads"], port["n_kv_heads"]
    hd = port.get("head_dim") or port["d_model"] // h
    every = port.get("hybrid_attn_every") or 0
    n = port["n_layers"] // every if every else port["n_layers"]
    out = []
    for s in steps:
        if not s.decode_keys:
            continue
        keys = sum(s.decode_keys)
        nbytes = keys * hkv * hd * 2 * 4 + len(s.decode_keys) * h * hd * 2 * 2
        out.append((n, 4.0 * keys * h * hd, nbytes, "fp32_flops"))
    return out
