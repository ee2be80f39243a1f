"""The SSD scan (``csrc/ssd_scan.cu``) of a prefill, with its final state:
per call the least work is the recurrence itself, 4 N P FLOPs a token and
head (state update and read-out), and x, dt, B, C read, y and the fp32
final state written once (bf16 inputs)."""
from collections import Counter

PATTERN = r"ssd_scan_(tc|fp32)"
COUNTER = "ssd_scan"


def calls(port, steps):
    s = port["ssm"]
    d_in = s["expand"] * port["d_model"]
    h, p, n, g_n = (d_in // s["head_dim"], s["head_dim"], s["state_dim"],
                    s["n_groups"])
    out = []
    for st in steps:
        for plen, b in Counter(st.prefills).items():
            tok = b * plen
            nbytes = tok * (2 * h * p * 2 + h * 2 + 2 * g_n * n * 2) \
                + h * 4 + b * h * n * p * 4
            out.append((port["n_layers"], 4.0 * tok * h * n * p, nbytes,
                        "bf16_flops"))
    return out
