"""deepseek-v2-lite as published: unnormalised top-k gates
(``MoEConfig.norm_topk_prob=False``) and YaRN rope scaling
(``ModelConfig.rope_scaling``), held to the benchmark's plain fp32
reference (``portbench/reference/moe.py``, written from the published
equations; no JAX here) at SMOKE widths, with the ramp of YaRN inside the
rope dims; the YaRN constants at the published numbers; the gates; the
expert tally (``models.moe.TALLY``) and its samples; and the plain rope
left as it was.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness.cell import model_config  # noqa: E402
from portbench.harness.weights import Draw, load_into  # noqa: E402
from portbench.reference import moe as ref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import RopeScaling  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.serve import scheduler as sched_mod  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

# the published rope_scaling (DeepSeek-V2-Lite's config.json)
YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"}

# deepseek-v2-lite's SMOKE widths, as published otherwise: at rope dims 8
# the published YaRN ramps over pairs 1..3 (low 1, high 3).  The
# cache-free forward takes the training route, GShard capacity: at
# capacity factor 8 (as the SMOKE config's) it drops no token
PORT = {"name": "dsv2lite-smoke", "family": "moe", "n_layers": 3,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 128,
        "vocab_size": 256, "tie_embeddings": False, "norm_eps": 1e-6,
        "rope_theta": 10000.0, "rope_scaling": YARN,
        "moe": {"n_experts": 8, "n_shared_experts": 2, "top_k": 3,
                "d_expert": 32, "n_dense_layers": 1, "capacity_factor": 8.0,
                "inference_capacity_factor": 0.0, "ragged_dropless": True,
                "norm_topk_prob": False},
        "mla": {"kv_lora_rank": 32, "q_lora_rank": 0, "rope_head_dim": 8,
                "nope_head_dim": 16, "v_head_dim": 16},
        "attention_impl": "pallas", "kernel_plan": "direct",
        "dtype": "float32"}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def smoke():
    """The SMOKE port config, its model on seeded weights, the weights."""
    draw = Draw(ref.leaves(PORT), 20261018, torch.device("cpu"),
                torch.float32)
    cfg = model_config(PORT)
    with torch.device("meta"):
        model = model_mod.build(cfg, torch.float32)
    load_into(model, draw)
    return cfg, model, draw


def _tokens(seed, n):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, PORT["vocab_size"], (n,), generator=g)


@pytest.fixture
def metrics():
    reg = obs.MetricsRegistry()
    old = obs.set_default_metrics(reg)
    try:
        yield reg
    finally:
        obs.set_default_metrics(old)


# ------------------------------------------------- against the reference --
@torch.no_grad()
def test_forward_matches_reference(smoke):
    """The cache-free forward; a port with the gates renormalised or
    without YaRN misses the reference by far more than the tolerance."""
    cfg, model, draw = smoke
    seqs = [_tokens(1, 37), _tokens(2, 50)]
    want = ref.forward(PORT, draw.fp32, seqs, [0, 0])
    for s, w in zip(seqs, want):
        got, _ = model_mod.forward(cfg, model, {"tokens": s[None]})
        torch.testing.assert_close(got[0], w, **TOL)
    for off in (dict(moe=dataclasses.replace(cfg.moe, norm_topk_prob=True)),
                dict(rope_scaling=None)):
        got, _ = model_mod.forward(dataclasses.replace(cfg, **off), model,
                                   {"tokens": seqs[1][None]})
        assert (got[0] - want[1]).abs().max() > 1e-3, off


@torch.no_grad()
def test_cached_prefill_and_slot_decode_match_reference(smoke):
    """A cached prefill per row, rows inserted into a per-slot cache, then
    decode steps at each row's own depth: every position's logits are the
    reference's full forward's."""
    cfg, model, draw = smoke
    cfg = dataclasses.replace(cfg, fresh_prefill_kernel=True)
    prompts = [_tokens(3, 11), _tokens(4, 23)]
    steps = 6
    full = [torch.cat([p, _tokens(10 + i, steps)])
            for i, p in enumerate(prompts)]
    want = ref.forward(PORT, draw.fp32, full,
                       [len(p) - 1 for p in prompts])
    cache = model_mod.init_cache(cfg, 2, 48, torch.float32,
                                 per_slot_pos=True)
    got = [[] for _ in prompts]
    for b, p in enumerate(prompts):
        one = model_mod.init_cache(cfg, 1, 48, torch.float32)
        lg, one = model_mod.decode_step(cfg, model, {"tokens": p[None]}, one)
        got[b].append(lg[0, -1])
        sched_mod.insert_rows(cache, one, [b], 1)
    for j in range(steps):
        tok = torch.stack([f[len(p) + j] for f, p in zip(full, prompts)])
        lg, cache = model_mod.decode_step(cfg, model,
                                          {"tokens": tok[:, None]}, cache)
        for b in range(2):
            got[b].append(lg[b, 0])
    for g, w in zip(got, want):
        torch.testing.assert_close(torch.stack(g), w[:steps + 1], **TOL)


@torch.no_grad()
def test_block_skipping_prefill_matches_reference(smoke):
    """A cached prefill whose attention runs in KV blocks of 4, each block
    of queries skipping the blocks after it (``chunked_attention``'s
    ``q_start``): every position's logits are the reference's, and equal
    the unsplit attention's within rounding."""
    cfg, model, draw = smoke
    seq = _tokens(5, 19)
    want = ref.forward(PORT, draw.fp32, [seq], [0])[0]
    for block in (4, 1024):
        c = dataclasses.replace(cfg, attn_block_kv=block)
        cache = model_mod.init_cache(c, 1, 24, torch.float32)
        lg, _ = model_mod.decode_step(c, model, {"tokens": seq[None]}, cache)
        torch.testing.assert_close(lg[0], want, **TOL)
    q, k, v = (torch.randn(1, 2, 19, 6, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    pos = torch.arange(19)
    torch.testing.assert_close(
        port_attn.chunked_attention(q, k, v, causal=True, q_pos=pos,
                                    block=4, q_start=0),
        port_attn.chunked_attention(q, k, v, causal=True, q_pos=pos,
                                    block=4), rtol=0, atol=1e-6)


@torch.no_grad()
def test_scheduler_stream_matches_reference(smoke):
    """The scheduler's served logits, every token of every request."""
    cfg, model, draw = smoke
    eng = Engine(cfg, model, ServeConfig(batch=1, max_len=48),
                 device="cpu")
    reqs = sched_mod.synthetic_workload(
        5, seed=3, prompt_lens=(5, 9, 17), new_tokens=(3, 6),
        arrival_rate=2.0, vocab=PORT["vocab_size"])
    done = eng.serve_stream(reqs, max_slots=3, collect_logits=True)
    by_rid = {r.rid: r for r in reqs}
    seqs, starts = [], []
    for c in done:
        p = torch.as_tensor(np.asarray(by_rid[c.rid].tokens),
                            dtype=torch.long)
        seqs.append(torch.cat([p, torch.as_tensor(c.tokens[:-1],
                                                  dtype=torch.long)]))
        starts.append(len(p) - 1)
    want = ref.forward(PORT, draw.fp32, seqs, starts)
    assert len(done) == 5
    for c, w in zip(done, want):
        torch.testing.assert_close(torch.as_tensor(c.logits), w, **TOL)


# ------------------------------------------------------ YaRN, the gates --
def test_yarn_constants_at_published_numbers():
    rs = RopeScaling(**YARN)
    assert rs.correction_range(64, 10000.0) == (10, 23)
    assert rs.rope_mscale == 1.0
    full = load_published()
    assert port_attn.mla_scale(full) == pytest.approx(0.114721, abs=5e-7)
    assert port_attn.mla_scale(dataclasses.replace(full, rope_scaling=None)) \
        == 192 ** -0.5
    inv = port_layers.rope_freqs(64, 10000.0, scaling=rs).double()
    base = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    ramp = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    torch.testing.assert_close(inv, base * (1 - ramp) + base / 40 * ramp,
                               rtol=1e-6, atol=0)


def load_published():
    """The benchmark's configuration file's ``port`` section."""
    conf = json.loads((ROOT / "portbench" / "configs" /
                       "deepseek-v2-lite-16b.json").read_text())
    cfg = model_config(conf["port"])
    assert cfg.rope_scaling == RopeScaling(**conf["rope_scaling"])
    return cfg


def test_plain_rope_unchanged():
    """``rope_scaling`` None takes the rope as it was, bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 9, 16, generator=g)
    pos = torch.arange(9) + 1000
    exps = torch.arange(0, 16, 2, dtype=torch.float32) / 16
    ang = pos[..., None].float() * (1.0 / (500000.0 ** exps))
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    old = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    for got in (port_layers.apply_rope(x, pos, 500000.0),
                port_layers.apply_rope(x, pos, 500000.0, None)):
        assert torch.equal(got, old)


def _gates(monkeypatch, norm: bool):
    """The gates ``moe_apply`` hands its route, and the router's
    probabilities."""
    cfg = model_config(PORT)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, norm_topk_prob=norm, ragged_dropless=False))
    p = port_moe.MoE(cfg)
    g = torch.Generator().manual_seed(5)
    for t in p.parameters():
        t.data.copy_(torch.randn(t.shape, generator=g) * 0.3)
    seen = {}

    def route(_p, xt, gate, idx, cap, phase=None):
        seen.update(gate=gate, idx=idx)
        return torch.zeros_like(xt)

    monkeypatch.setattr(port_moe, "_capacity_experts", route)
    x = torch.randn(2, 5, PORT["d_model"], generator=g)
    port_moe.moe_apply(p, cfg, x, dropless=True)
    probs = torch.softmax(x.reshape(10, -1) @ p.router.w, dim=-1)
    return seen, probs


def test_gates(monkeypatch):
    raw, probs = _gates(monkeypatch, norm=False)
    top = torch.topk(probs, PORT["moe"]["top_k"], dim=-1)
    assert torch.equal(raw["idx"], top.indices)
    torch.testing.assert_close(raw["gate"], top.values, rtol=1e-6, atol=0)
    assert (raw["gate"].sum(-1) - 1).abs().max() > 1e-3
    normed, _ = _gates(monkeypatch, norm=True)
    torch.testing.assert_close(normed["gate"].sum(-1), torch.ones(10))
    torch.testing.assert_close(normed["gate"],
                               top.values / top.values.sum(-1, keepdim=True))


# ------------------------------------------------------ the expert tally --
def _routed_moe(ragged: bool):
    """An MoE layer whose router sends a token whose feature j is 10 to the
    experts ``HITS[j]`` (and nothing else)."""
    cfg = model_config(PORT)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, ragged_dropless=ragged))
    p = port_moe.MoE(cfg)
    for t in p.parameters():
        t.data.zero_()
    for j, experts in HITS.items():
        p.router.w.data[j, list(experts)] = 1.0
    return cfg, p


HITS = {0: (1, 4, 6), 1: (1, 2, 3), 2: (5, 6, 7)}


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "capacity"])
def test_tally_counts_the_experts_a_routing_hits(metrics, ragged):
    cfg, p = _routed_moe(ragged)
    tally = port_moe.TALLY
    tally.reset()
    d = PORT["d_model"]
    for feats, s in (((0, 1), 1), ((2, 2, 2), 1), ((0, 0, 2, 1), 4)):
        x = torch.zeros(len(feats), s, d)
        for b, j in enumerate(feats):
            x[b, :, j] = 10.0
        port_moe.moe_apply(p, cfg, x, dropless=True)
    tally.fold()
    k, e = PORT["moe"]["top_k"], PORT["moe"]["n_experts"]
    want = {"decode_calls": [2], "decode_rows": [5 * k],
            # {1, 2, 3, 4, 6} then {5, 6, 7}
            "decode_experts_hit": [8],
            "prefill_calls": [1], "prefill_rows": [16 * k],
            "prefill_experts_hit": [7]}
    for name, v in want.items():
        assert metrics.histogram(f"moe.{name}").values == v, name
    buf = metrics.histogram("moe.decode_buffer_rows").values[0]
    # the ragged buffer: (⌈t·k / 16⌉ + E) tiles of 16; capacity: E · t·k
    assert buf == (16 * (1 + e) + 16 * (1 + e) if ragged
                   else e * 2 * k + e * 3 * k)


def test_tally_samples_only_while_profiled(smoke, metrics):
    cfg, model, _ = smoke
    eng = Engine(cfg, model, ServeConfig(batch=2, max_len=24),
                 device="cpu")
    prompt = torch.stack([_tokens(7, 6), _tokens(8, 6)])
    eng.generate(prompt, 3)
    names = [f"moe.{ph}_{x}" for ph in port_moe.PHASES
             for x in ("calls", "rows", "buffer_rows", "experts_hit")]
    assert all(metrics.histogram(n).count == 0 for n in names)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.generate(prompt, 3)
    n_moe = PORT["n_layers"] - PORT["moe"]["n_dense_layers"]
    k, e = PORT["moe"]["top_k"], PORT["moe"]["n_experts"]
    h = metrics.histogram
    assert h("moe.prefill_calls").values == [n_moe]
    assert h("moe.prefill_rows").values == [n_moe * 2 * 6 * k]
    # generate's three decode steps, the last one's token unused
    assert h("moe.decode_calls").values == [n_moe] * 3
    assert h("moe.decode_rows").values == [n_moe * 2 * k] * 3
    for ph in port_moe.PHASES:
        for v, c in zip(h(f"moe.{ph}_experts_hit").values,
                        h(f"moe.{ph}_calls").values):
            assert k <= v / c <= e
