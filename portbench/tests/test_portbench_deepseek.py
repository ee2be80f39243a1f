"""The deepseek-v2-lite cell's files: the MoE reference against the
program's plain serving route at SMOKE widths, the configuration's
published keys against its ``port`` section, the grouped GEMM's bound
and the experts-hit reading from samples worked by hand, and the MoE
family's model FLOPs."""
import json
import time
from pathlib import Path

import pytest
import torch

from portbench.harness.cell import model_config
from portbench.harness.loop import Step
from portbench.harness.trace import load_module
from portbench.harness.weights import Draw, load_into
from portbench.reference import moe

ROOT = Path(__file__).resolve().parents[1]
DSV2 = json.loads((ROOT / "configs" / "deepseek-v2-lite-16b.json")
                  .read_text())

# deepseek-v2-lite at SMOKE widths, as published otherwise (YaRN ramping
# inside its 8 rope dims, gates unnormalised)
MOE = {
    "name": "dsv2lite-smoke", "reference": "moe",
    "port": {"name": "dsv2lite-smoke", "family": "moe", "n_layers": 3,
             "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 128,
             "vocab_size": 256, "tie_embeddings": False, "norm_eps": 1e-6,
             "rope_theta": 10000.0,
             "rope_scaling": DSV2["rope_scaling"],
             "moe": {"n_experts": 8, "n_shared_experts": 2, "top_k": 3,
                     "d_expert": 32, "n_dense_layers": 1,
                     "inference_capacity_factor": 0.0,
                     "ragged_dropless": True, "norm_topk_prob": False},
             "mla": {"kv_lora_rank": 32, "q_lora_rank": 0,
                     "rope_head_dim": 8, "nope_head_dim": 16,
                     "v_head_dim": 16},
             "attention_impl": "xla_chunked", "kernel_plan": "direct",
             "dtype": "float32"},
    "serve": {"cache_dtype": "float32"},
    "kernels": ["grouped_gemm"],
}


@pytest.mark.parametrize("norm", [False, True], ids=["published", "norm"])
def test_reference_matches_plain_route(norm):
    from repro_torch.models import model as model_mod
    port = dict(MOE["port"], moe=dict(MOE["port"]["moe"],
                                      norm_topk_prob=norm))
    draw = Draw(moe.leaves(port), 20260101, torch.device("cpu"),
                torch.float32)
    cfg = model_config(port)
    with torch.device("meta"):
        model = model_mod.build(cfg, torch.float32)
    load_into(model, draw)
    g = torch.Generator().manual_seed(3)
    tokens = [torch.randint(0, port["vocab_size"], (n,), generator=g)
              for n in (37, 64)]
    with torch.no_grad():
        want = moe.forward(port, draw.fp32, tokens, [0, 5])
        for t, w in zip(tokens, want):
            cache = model_mod.init_cache(cfg, 1, 64, torch.float32)
            got, _ = model_mod.decode_step(cfg, model, {"tokens": t[None]},
                                           cache)
            torch.testing.assert_close(got[0, -w.shape[0]:], w, rtol=1e-5,
                                       atol=1e-5)


def test_deepseek_file_matches_its_port_section():
    p, m, mla = DSV2["port"], DSV2["port"]["moe"], DSV2["port"]["mla"]
    for port_key, key in (("n_layers", "num_hidden_layers"),
                          ("d_model", "hidden_size"),
                          ("n_heads", "num_attention_heads"),
                          ("n_kv_heads", "num_key_value_heads"),
                          ("d_ff", "intermediate_size"),
                          ("vocab_size", "vocab_size"),
                          ("norm_eps", "rms_norm_eps"),
                          ("rope_theta", "rope_theta")):
        assert p[port_key] == DSV2[key], port_key
    assert p["rope_scaling"] == DSV2["rope_scaling"]
    assert p["tie_embeddings"] == DSV2["tie_word_embeddings"]
    assert (m["n_experts"], m["n_shared_experts"], m["top_k"],
            m["d_expert"], m["n_dense_layers"], m["norm_topk_prob"]) == (
        DSV2["n_routed_experts"], DSV2["n_shared_experts"],
        DSV2["num_experts_per_tok"], DSV2["moe_intermediate_size"],
        DSV2["first_k_dense_replace"], DSV2["norm_topk_prob"])
    assert (mla["kv_lora_rank"], mla["rope_head_dim"], mla["nope_head_dim"],
            mla["v_head_dim"]) == (DSV2["kv_lora_rank"],
                                   DSV2["qk_rope_head_dim"],
                                   DSV2["qk_nope_head_dim"],
                                   DSV2["v_head_dim"])
    assert DSV2["q_lora_rank"] is None and mla["q_lora_rank"] == 0
    # dropless serving, every routed token computed, as the model is
    assert m["ragged_dropless"] and m["inference_capacity_factor"] <= 0
    # greedy top-k over one group, a softmax router, no routed scaling
    assert (DSV2["topk_method"], DSV2["n_group"], DSV2["topk_group"],
            DSV2["scoring_func"], DSV2["routed_scaling_factor"],
            DSV2["moe_layer_freq"]) == ("greedy", 1, 1, "softmax", 1, 1)
    cfg = model_config(p)
    assert cfg.rope_scaling.factor == 40 and not cfg.moe.norm_topk_prob


@pytest.fixture
def samples():
    """A private metrics registry, and a writer of one step's samples."""
    from repro_torch import obs
    reg = obs.MetricsRegistry()
    old = obs.set_default_metrics(reg)

    def step(**phases):
        t0 = time.perf_counter()
        for phase, (calls, rows, hit) in phases.items():
            for name, v in (("calls", calls), ("rows", rows),
                            ("experts_hit", hit)):
                reg.histogram(f"moe.{phase}_{name}").record(v)
        return Step(t0, time.perf_counter(), 0, 0)

    try:
        yield step
    finally:
        obs.set_default_metrics(old)


def test_grouped_gemm(samples):
    port = DSV2["port"]
    # a decode step of 32 lanes: 26 calls of 192 routed rows, 60 experts
    # hit a call; a 1500-token prefill: 26 calls of 9000 rows, all 64
    steps = [samples(decode=(26, 26 * 192, 26 * 60)),
             samples(prefill=(26, 26 * 9000, 26 * 64))]
    calls = load_module("roofline", "grouped_gemm").calls(port, steps)
    d, de = 2048, 1408
    assert sorted(calls) == sorted([
        (78, 2 * 9000 * d * de,
         2 * (9000 * (d + de) + 64 * d * de), "bf16_flops"),
        (78, 2 * 192 * d * de, 2 * (192 * (d + de) + 60 * d * de),
         "bf16_flops")])
    # outside the steps' times: nothing
    late = samples(decode=(26, 26 * 192, 26 * 60))
    assert len(load_module("roofline", "grouped_gemm").calls(port, steps)) \
        == 2 and late.t0 > steps[-1].t1


def test_experts_hit_pct(samples):
    class W:
        port = DSV2["port"]
        t1 = time.perf_counter()

    w = W()
    samples(decode=(26, 26 * 192, 26 * 48))
    samples(decode=(26, 26 * 192, 26 * 64), prefill=(26, 1, 26 * 64))
    got = load_module("metrics", "moe_experts_hit_pct").read(w)
    assert got == pytest.approx(100.0 * (48 + 64) / 2 / 64)
    w.t1 = time.perf_counter()
    assert load_module("metrics", "moe_experts_hit_pct").read(w) is None


def test_token_flops():
    p = DSV2["port"]
    f0 = moe.token_flops(p, 0, False)
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    ffn = 3 * 2048 * 10944 + 26 * (2048 * 64 + 3 * 2048 * 1408 * 8)
    assert f0 == 2 * (27 * attn + ffn)
    # 2.24 B active parameters besides the embedding and the head, 2 FLOPs
    # each (the published 2.4 B counts one of the two 0.21 B tables)
    assert 4.48e9 < f0 < 4.49e9
    assert moe.token_flops(p, 10, True) - f0 == \
        27 * 2 * 10 * 16 * (192 + 128) + 2 * 2048 * 102400


def test_yarn_constants():
    inv, cos_sin, soft = moe.yarn(64, 10000.0, DSV2["rope_scaling"])
    assert cos_sin == 1.0
    assert 192 ** -0.5 * soft == pytest.approx(0.114721, abs=5e-7)
    base = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    assert torch.equal(inv[:11], base[:11])
    assert torch.equal(inv[23:], base[23:] / 40)
