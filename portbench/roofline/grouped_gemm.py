"""The grouped GEMM (``csrc/grouped_gemm.cu``) of the MoE layers: each
layer call's three expert products, gate and up (rows x d -> d_expert)
and down (rows x d_expert -> d), one launch each.  Per launch the least
work is 2 rows d d_expert FLOPs over the call's routed rows (t k), and
the bytes those rows in and out once plus the weights of the experts the
call hit, read once.  Calls, rows and experts hit are the program's own
samples (``moe.<phase>_calls``, ``_rows``, ``_experts_hit``: one of each
a prefill or decode step, stamped inside the traced steps, recorded only
while a profiler records); a step's calls of one phase are taken at their
mean, which keeps the sum a lower bound.  A program that records no such
sample gives no calls."""
from repro_torch import obs

PATTERN = r"gg_(mma|fma)<"
COUNTER = "grouped_gemm"
PHASES = ("prefill", "decode")


def _samples(name, t0, t1):
    between = getattr(obs.default_metrics().histogram(name), "between", None)
    return between(t0, t1) if between else []


def calls(port, steps):
    if not steps:
        return []
    d, de = port["d_model"], port["moe"]["d_expert"]
    bf16 = port.get("dtype", "bfloat16") == "bfloat16"
    isz, peak = (2, "bf16_flops") if bf16 else (4, "fp32_flops")
    t0, t1 = steps[0].t0, steps[-1].t1
    out = []
    for phase in PHASES:
        got = [_samples(f"moe.{phase}_{k}", t0, t1)
               for k in ("calls", "rows", "experts_hit")]
        for n, rows, hit in zip(*got):
            if not n:
                continue
            r, e = rows / n, hit / n
            out.append((3 * int(n), 2.0 * r * d * de,
                        isz * (r * (d + de) + e * d * de), peak))
    return out
