"""The bound arithmetic of each kernel and the model FLOPs against hand
counts at the cells' widths."""
import json
from pathlib import Path

from portbench.harness.loop import Step
from portbench.harness.trace import load_module
from portbench.reference import dense, ssm

ROOT = Path(__file__).resolve().parents[1]
QWEN2 = json.loads((ROOT / "configs" / "qwen2-7b.json").read_text())["port"]
MAMBA2 = json.loads((ROOT / "configs" / "mamba2-1.3b.json")
                    .read_text())["port"]


def test_flash():
    calls = load_module("roofline", "flash").calls(
        QWEN2, [Step(0, 1, 1, 1, prefills=[1000, 1000, 7])])
    assert sorted(c[0] for c in calls) == [28, 28]
    big = max(calls, key=lambda c: c[1])
    # two prompts of 1000 as one batch-2 call: 4 D FLOPs a key and head
    assert big[1] == 2 * 28 * 4 * 128 * (1000 * 1001 / 2)
    # q and o over 28 heads, k and v over 4, bf16, batch 2
    assert big[2] == 2 * 2 * 1000 * 128 * (2 * 28 + 2 * 4)


def test_ssd_scan():
    (n, fl, nb, pk), = load_module("roofline", "ssd_scan").calls(
        MAMBA2, [Step(0, 1, 1, 1, prefills=[100])])
    assert n == 48 and pk == "bf16_flops"
    assert fl == 4 * 100 * 64 * 128 * 64
    per_tok = 2 * 64 * 64 * 2 + 64 * 2 + 2 * 128 * 2
    assert nb == 100 * per_tok + 64 * 4 + 64 * 128 * 64 * 4


def test_decode_kernels():
    steps = [Step(0, 1, 0, 2, decode_keys=[10, 20])]
    (n, fl, nb, _), = load_module("roofline", "decode_attn").calls(QWEN2,
                                                                   steps)
    assert n == 28 and fl == 4 * 30 * 28 * 128
    assert nb == 30 * 4 * 128 * 2 * 4 + 2 * 28 * 128 * 2 * 2
    (n, fl, nb, _), = load_module("roofline", "ssd_decode").calls(MAMBA2,
                                                                  steps)
    assert n == 48 and fl == 4 * 2 * 64 * 128 * 64
    assert nb == 2 * (2 * 64 * 128 * 64 * 4 + 2 * 64 * 64 * 4
                      + 2 * 128 * 4 + 64 * 2) + 64 * 4


def test_token_flops():
    # qwen2-7b: 28 layers of GQA 28/4 x 128 and SwiGLU 18944, own head
    q0 = dense.token_flops(QWEN2, 0, False)
    layer = 3584 * (28 + 8) * 128 + 28 * 128 * 3584 + 3 * 3584 * 18944
    assert q0 == 2 * 28 * layer
    assert dense.token_flops(QWEN2, 10, True) - q0 == \
        28 * 4 * 10 * 28 * 128 + 2 * 3584 * 152064
    # 7.6 B parameters less the embedding and head: 6.5 B, 2 FLOPs each
    assert 12.9e9 < q0 < 13.2e9
    # mamba2-1.3b: 48 mixers, tied head
    m0 = ssm.token_flops(MAMBA2, 0, False)
    mixer = 2048 * (2 * 4096 + 2 * 128 + 64) + 4096 * 2048
    assert m0 == 2 * 48 * mixer + 48 * 4 * 64 * 128 * 64
    assert ssm.token_flops(MAMBA2, 10, True) - m0 == 2 * 2048 * 50288
