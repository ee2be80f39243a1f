"""The SSD decode step (``csrc/ssd_decode.cu``) of one scheduler step:
per lane and head the fp32 state read and written once (4 N P FLOPs), and
the step's x, B, C (fp32: the conv window joins the fp32 cached tail),
dt (bf16) and y."""
PATTERN = r"ssd_decode_kernel"
COUNTER = "ssd_decode"


def calls(port, steps):
    s = port["ssm"]
    d_in = s["expand"] * port["d_model"]
    h, p, n, g_n = (d_in // s["head_dim"], s["head_dim"], s["state_dim"],
                    s["n_groups"])
    out = []
    for st in steps:
        b = len(st.decode_keys)
        if not b:
            continue
        nbytes = b * (2 * h * n * p * 4 + 2 * h * p * 4 + 2 * g_n * n * 4
                      + h * 2) + h * 4
        out.append((port["n_layers"], 4.0 * b * h * n * p, nbytes,
                    "fp32_flops"))
    return out
