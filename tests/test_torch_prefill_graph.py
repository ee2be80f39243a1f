"""The engine's fresh prefill replayed per length bucket as a CUDA graph
(``repro_torch.serve.prefill_graph``).

On the CPU: the buckets, the engine's choice of bucket (its own on the
card, the configuration's where it sets one, none off the card), the
memory rule, the rule that decides when a prefill may replay, and the
padded prefill (each bucket's backbone run eagerly into the static
buffers, ``warm(capture=False)``) against the eager, unpadded one: logits
and every cache row, for a GQA model, a biased GQA model at the engine's
bucket and an MLA + MoE model.  On the card (marked ``cuda``): a deepseek
SMOKE stream whose prefills replay gives the eager stream's tokens, its
logits within rounding, and the same grouped GEMM launches; a biased GQA
SMOKE stream under ``kernel_plan='measure'`` at the engine's own bucket
the same, with the same flash launches.
"""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import RopeScaling, load_arch  # noqa: E402
from repro_torch.kernels import grouped_gemm  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import prefill_graph as pg  # noqa: E402
from repro_torch.serve import scheduler as sched_mod  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

RAGGED = dict(ragged_dropless=True, inference_capacity_factor=0.0)


@pytest.fixture
def metrics():
    """A private metrics registry for the test."""
    reg = obs.MetricsRegistry()
    old = obs.set_default_metrics(reg)
    try:
        yield reg
    finally:
        obs.set_default_metrics(old)


def _counters(reg):
    return reg.snapshot(include_views=False)["counters"]


def _cfg(arch, bucket=16, **kw):
    """``arch``'s SMOKE config on the kernels' routes with a prefill bucket;
    deepseek as published (gates unnormalised, YaRN) on the direct ragged
    route.  ``moe`` replaces MoE fields."""
    cfg = load_arch(arch, smoke=True)
    extra = {}
    if cfg.moe is not None:
        extra = dict(rope_scaling=RopeScaling(factor=40.0, mscale=0.707,
                                              mscale_all_dim=0.707),
                     moe=dataclasses.replace(cfg.moe, norm_topk_prob=False,
                                             **dict(RAGGED,
                                                    **kw.pop("moe", {}))))
    kw = dict(dict(attention_impl="pallas", kernel_plan="direct"), **kw)
    return dataclasses.replace(cfg, prefill_graph_bucket=bucket, **extra,
                               **kw)


# ----------------------------------------------------------- the buckets --
def test_buckets():
    """Multiples of the bucket below max_len, then max_len; a length runs
    at the least bucket that holds it."""
    got = pg.buckets(128, 4257)
    assert got[:3] == [128, 256, 384] and got[-2:] == [4224, 4257]
    assert len(got) == 34
    assert pg.buckets(16, 48) == [16, 32, 48]
    for s, want in ((1, 128), (128, 128), (129, 256), (1500, 1536),
                    (4000, 4096), (4224, 4224), (4225, 4257),
                    (4257, 4257)):
        assert pg.bucket_of(s, 128, 4257) == want, s


# ------------------------------------------------- the engine's choice --
@pytest.mark.parametrize("bucket", [0, 16])
def test_engine_bucket(bucket):
    """A configuration's bucket is kept on and off the card; at the
    reference's 0 the engine takes its own on a CUDA device and none off
    it."""
    cfg = _cfg("qwen2-7b", bucket=bucket)
    want = bucket or pg.ENGINE_BUCKET
    assert pg.engine_bucket(cfg, torch.device("cuda")) == want
    assert pg.engine_bucket(cfg, torch.device("cpu")) == bucket


def test_default_engine_off_the_card_neither_captures_nor_counts(metrics):
    """A configuration at the default 0, served off the card: the engine
    keeps 0, captures nothing and counts no eager prefill; each prefill
    leaves one 0 sample of ``engine.prefill_graph``."""
    cfg = _cfg("qwen2-7b", bucket=0)
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, ServeConfig(batch=1, max_len=48), device="cpu")
    assert eng.cfg.prefill_graph_bucket == 0
    eng.generate(torch.zeros((1, 5), dtype=torch.long), 2)
    eng.prefill(torch.zeros((1, 9), dtype=torch.long))
    assert eng._prefill.replays == 0
    assert not [k for k in _counters(metrics)
                if k.startswith("engine.prefill_graph")]
    assert metrics.histogram("engine.prefill_graph").between(
        0.0, float("inf")) == [0.0, 0.0]


def test_state_bytes_worked_by_hand():
    """qwen2-7b at batch 1 and 4257 slots on the flash route: the fp32
    cache (28 layers, K and V, 4 heads of 128), the static tokens and
    hidden states, and a layer's bf16 working set a token (3 d and the
    feed-forward's 3 d_ff, wider than attention's q, k, v, the rope's fp32
    copies and the output); 1.09 GB, within 2% of an 80 GB card, and at
    32 rows it is not.  deepseek-v2-lite: MLA off the flash kernel (its
    fp32 scores over a block of 1024 queries and keys) and the ragged
    route's k (4 d + 2 d_expert), the routing and the shared experts."""
    cfg = dataclasses.replace(load_arch("qwen2-7b"), attention_impl="pallas")
    cache = 28 * 2 * 4 * 4257 * 128 * 4
    attn = (28 + 2 * 4) * 128 + 2 * (28 + 4) * 128 * 2 + 28 * 128
    assert attn < 3 * 18944
    layer = 4257 * (3 * 3584 + 3 * 18944) * 2
    want = cache + 4257 * (8 + 3584 * 2) + layer
    assert pg.state_bytes(cfg, 1, 4257, torch.float32) == want
    assert want / 80e9 == pytest.approx(0.013677, abs=1e-6)
    assert pg.state_bytes(cfg, 32, 4257, torch.float32) \
        > pg.MEMORY_SHARE * 80e9
    moe = load_arch("deepseek-v2-lite-16b")
    attn = 3 * 16 * 192 + 16 * 256 + 2 * 16 * 128 + 2 * (512 + 64)
    ffn = 6 * (4 * 2048 + 2 * 1408) + 4 * 64 + 3 * 2 * 1408
    assert attn < ffn and 3 * 10944 < ffn
    layer = 4257 * (3 * 2048 + ffn) * 2 + 64 * 16 * (2048 + 2 * 1408) * 2 \
        + 3 * 4 * 16 * 1024 * 1024
    assert pg.state_bytes(moe, 1, 4257, torch.float32) == \
        27 * 4257 * (512 + 64) * 4 + 4257 * (8 + 2048 * 2) + layer


def test_memory_rule_refuses_and_counts(metrics):
    """Where the captured state would take more than ``MEMORY_SHARE`` of
    the card, ``warm`` captures nothing and every prefill runs eagerly,
    counted with the reason ``memory``; within it the buckets are made."""
    cfg = dataclasses.replace(_cfg("qwen3-0.6b"), fresh_prefill_kernel=True)
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    need = pg.state_bytes(cfg, 2, 48, torch.float32)
    small = pg.PrefillGraph(torch.device("cpu"))
    assert small.warm(cfg, model, 2, 48, torch.float32, capture=False,
                      card_bytes=need * 49) == 0
    assert small.refused == "memory"
    tokens = torch.zeros((2, 5), dtype=torch.long)
    cache = model_mod.init_cache(cfg, 2, 48, torch.float32)
    with torch.no_grad():
        small(cfg, model, {"tokens": tokens}, cache, last_only=True)
    assert small.replays == 0
    ctr = _counters(metrics)
    assert ctr["engine.prefill_graph_eager.memory"] == 1
    assert "engine.prefill_graph_warm_s" not in metrics.snapshot(
        include_views=False)["histograms"]
    fits = pg.PrefillGraph(torch.device("cpu"))
    assert fits.warm(cfg, model, 2, 48, torch.float32, capture=False,
                     card_bytes=need * 51) == 3
    assert fits.refused is None


# -------------------------------------------------------------- the rule --
@pytest.mark.parametrize("arch,kw,per_slot,want", [
    ("qwen3-0.6b", {}, False, None),
    ("qwen3-0.6b", dict(cfg=dict(bucket=0)), False, "off"),
    ("mamba2-1.3b", {}, False, "family"),
    ("zamba2-2.7b", {}, False, "family"),
    ("qwen3-0.6b", dict(mesh=object()), False, "mesh"),
    ("qwen3-0.6b", dict(nan_guard=True), False, "nan_guard"),
    ("qwen3-0.6b", dict(rules=True), False, "faults"),
    ("qwen3-0.6b", {}, True, "not_fresh"),
    ("deepseek-v2-lite-16b", dict(cfg=dict(kernel_plan="measure")), False,
     "moe"),
    ("deepseek-v2-lite-16b", {}, False, None),
    ("deepseek-v2-lite-16b",
     dict(cfg=dict(moe=dict(inference_capacity_factor=2.0))), False,
     "capacity"),
    ("deepseek-v2-lite-16b",
     dict(cfg=dict(moe=dict(ragged_dropless=False))), False, "capacity"),
], ids=["dense", "off", "ssm", "hybrid", "mesh", "nan_guard", "faults",
        "per_slot", "moe_registry", "moe_ragged_direct", "moe_capacity",
        "moe_dense_dropless"])
def test_engage_rule(arch, kw, per_slot, want):
    """A fresh int-pos cache of K/V or MLA rows, in the dense or MoE
    family, unguarded, off any mesh and with every MoE layer on the direct
    ragged route (neither the registry's nor the capacity route, capped
    or not), under a bucket > 0, may replay; every other prefill is eager
    with its reason."""
    kw = dict(kw)
    cfg = _cfg(arch, **kw.pop("cfg", {}))
    cache = model_mod.init_cache(cfg, 2, 16, torch.float32,
                                 torch.device("meta"),
                                 per_slot_pos=per_slot)
    rules = kw.pop("rules", False)
    with faults.inject(*([faults.FaultRule("engine.prefill", "error")]
                         if rules else [])):
        assert pg.eager_reason(cfg, cache, **kw) == want


def test_continuation_is_not_fresh():
    """A cache already holding tokens (int pos > 0) is no fresh prefill."""
    cfg = _cfg("qwen3-0.6b")
    cache = model_mod.init_cache(cfg, 1, 16, torch.float32,
                                 torch.device("meta"))
    cache = {seg: [dict(layer, pos=4) for layer in layers]
             for seg, layers in cache.items()}
    assert pg.eager_reason(cfg, cache) == "not_fresh"


# ---------------------------------------------------- the padded prefill --
def _moe_calls() -> int:
    return sum(h[0] for h in moe_mod.TALLY.host.values())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-lite-16b"])
def test_padded_prefill_gives_the_eager_prefill(arch, metrics):
    """Each bucket's backbone over the prompt and the padding after it,
    then the head at the prompt's last position, gives the eager unpadded
    prefill's logits and cache rows (all positions under
    ``last_only=False``); ``pos`` is the prompt's length, the kernels'
    launch counters and the MoE tally count what the eager run counts."""
    cfg = dataclasses.replace(_cfg(arch), fresh_prefill_kernel=True)
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    graph = pg.PrefillGraph(torch.device("cpu"))
    assert graph.warm(cfg, model, 2, 48, torch.float32,
                      capture=False) == 3
    gen = torch.Generator().manual_seed(1)
    replays = 0
    for s in (1, 17, 47, 48):
        for last_only in (True, False):
            tokens = torch.randint(0, cfg.vocab_size, (2, s), generator=gen)
            outs, calls = [], []
            for step in (model_mod.decode_step, graph):
                cache = model_mod.init_cache(cfg, 2, 48, torch.float32)
                before = _moe_calls()
                with torch.no_grad():
                    outs.append(step(cfg, model, {"tokens": tokens}, cache,
                                     last_only=last_only))
                calls.append(_moe_calls() - before)
            (want, wc), (got, gcache) = outs
            replays += 1
            assert graph.replays == replays
            assert got.shape == want.shape == (2, 1 if last_only else s,
                                               cfg.vocab_size)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)
            for seg in wc:
                for lw, lg in zip(wc[seg], gcache[seg]):
                    assert lg["pos"] == lw["pos"] == s
                    for name in lw:
                        if name != "pos":
                            np.testing.assert_allclose(
                                lg[name].numpy(), lw[name].numpy(),
                                rtol=1e-5, atol=1e-5)
            # off the card a bucket's run is the eager backbone: the MoE
            # calls count once a layer, as eager (a 1-token prompt's as a
            # decode call there, as a prefill call at its bucket here)
            assert calls[0] == calls[1]
    assert "engine.prefill_graph_eager" not in _counters(metrics)


def test_capacity_route_prefill_stays_eager(metrics):
    """deepseek SMOKE on the capped capacity route (icf 0.5), where the
    eager prefill drops tokens: the padding would be routed too, raising
    the cap and, in the stable sort by expert, coming before the next
    row's real tokens, so a padded backbone drops another set of them and
    gives other logits.  So ``warm`` captures nothing and every prefill
    runs eagerly, counted with the reason ``capacity``, and gives the
    eager prefill exactly."""
    cfg = _cfg("deepseek-v2-lite-16b", fresh_prefill_kernel=True,
               moe=dict(ragged_dropless=False, inference_capacity_factor=0.5))
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, inference_capacity_factor=0.0))
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    graph = pg.PrefillGraph(torch.device("cpu"))
    assert graph.warm(cfg, model, 2, 48, torch.float32, capture=False) == 0

    def fresh():
        return model_mod.init_cache(cfg, 2, 48, torch.float32)

    with torch.no_grad():
        want, _ = model_mod.decode_step(cfg, model, {"tokens": tokens},
                                        fresh())
        kept, _ = model_mod.decode_step(dropless, model, {"tokens": tokens},
                                        fresh())
        got, gcache = graph(cfg, model, {"tokens": tokens}, fresh())
        padded = torch.cat([tokens, torch.zeros((2, 15), dtype=torch.long)],
                           dim=1)
        hidden, _ = transformer.decode_hidden(cfg, model, padded, fresh())
        by_pad = transformer.head_logits(cfg, model, hidden[:, :17])
    assert not torch.allclose(want, kept, atol=1e-3)        # it drops
    assert torch.equal(got, want)
    assert all(layer["pos"] == 17 for layer in gcache["blocks"])
    assert not torch.allclose(by_pad, want, atol=1e-3)
    assert graph.replays == 0
    assert _counters(metrics)["engine.prefill_graph_eager.capacity"] == 1


def test_biased_gqa_prefill_at_the_engines_bucket(metrics):
    """A dense GQA model with nonzero q / k / v biases at the default 0,
    given the bucket an engine on the card takes (128; buckets 128, 256,
    300 at ``max_len`` 300), run off the card: each padded prefill gives
    the eager prefill's logits and cache rows at 1e-5, the last bucket
    included."""
    cfg = _cfg("qwen2-7b", bucket=0, fresh_prefill_kernel=True)
    assert cfg.qkv_bias
    cfg = dataclasses.replace(
        cfg, prefill_graph_bucket=pg.engine_bucket(cfg, torch.device("cuda")))
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".wq.b", ".wk.b", ".wv.b")):
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))
    graph = pg.PrefillGraph(torch.device("cpu"))
    assert graph.warm(cfg, model, 1, 300, torch.float32,
                      capture=False) == 3
    for s in (1, 100, 129, 257, 300):
        tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen)
        outs = []
        for step in (model_mod.decode_step, graph):
            cache = model_mod.init_cache(cfg, 1, 300, torch.float32)
            with torch.no_grad():
                outs.append(step(cfg, model, {"tokens": tokens}, cache,
                                 last_only=True))
        (want, wc), (got, gcache) = outs
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        for lw, lg in zip(wc["blocks"], gcache["blocks"]):
            assert lg["pos"] == lw["pos"] == s
            for name in ("k", "v"):
                np.testing.assert_allclose(lg[name].numpy(),
                                           lw[name].numpy(), rtol=1e-5,
                                           atol=1e-5)
    assert graph.replays == 5
    assert "engine.prefill_graph_eager" not in _counters(metrics)


def test_engine_off_the_card_counts_its_eager_prefills(metrics):
    """Off the card the engine captures nothing: with a bucket each
    prefill is eager as ``not_captured``; with none, nothing is counted."""
    for bucket in (16, 0):
        cfg = _cfg("qwen3-0.6b", bucket=bucket)
        model = convert.init_params(cfg, torch.Generator().manual_seed(0))
        eng = Engine(cfg, model, ServeConfig(batch=1, max_len=48),
                     device="cpu")
        eng.generate(torch.zeros((1, 5), dtype=torch.long), 2)
        assert eng._prefill.replays == 0
    ctr = _counters(metrics)
    assert ctr["engine.prefill_graph_eager"] == 1
    assert ctr["engine.prefill_graph_eager.not_captured"] == 1


# -------------------------------------------------------------- the card --
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python -m pytest "
                    "-m cuda tests/test_torch_prefill_graph.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stream_prefills_replay_with_the_eager_tokens(card):
    """A deepseek SMOKE stream of whole-prompt prefills: with a bucket of
    16 every prefill replays its bucket's graph (3 captured at batch 4,
    max_len 48) and the stream gives the eager (``nan_guard``) engine's
    tokens, logits within rounding and the same grouped GEMM launches."""
    reqs = sched_mod.synthetic_workload(
        12, seed=7, prompt_lens=(2, 5, 9, 14, 30), new_tokens=(3, 5, 8),
        arrival_rate=2.0, vocab=256)
    out = {}
    for bucket, guard in ((16, False), (0, True)):
        reg = obs.MetricsRegistry()
        old = obs.set_default_metrics(reg)
        try:
            cfg = _cfg("deepseek-v2-lite-16b", bucket=bucket)
            model = convert.init_params(cfg,
                                        torch.Generator().manual_seed(0))
            eng = Engine(cfg, model, ServeConfig(batch=4, max_len=48,
                                                 nan_guard=guard),
                         device=card)
            before = grouped_gemm.launches
            done = eng.serve_stream(reqs, collect_logits=True, max_slots=4,
                                    step_time_ms=1.0)
            torch.cuda.synchronize()
            out[bucket] = dict(done=done,
                               launched=grouped_gemm.launches - before,
                               replays=eng._prefill.replays,
                               prefills=eng.stats()["phases"]["prefill"],
                               counters=_counters(reg))
        finally:
            obs.set_default_metrics(old)
        del eng
        gc.collect()
    g, e = out[16], out[0]
    assert g["counters"]["engine.prefill_graph_capture"] == 3
    assert "engine.prefill_graph_eager" not in g["counters"]
    assert g["replays"] == g["prefills"]["steps"] + 1 > 3
    assert e["replays"] == 0
    assert g["launched"] == e["launched"] > 0
    assert [c.rid for c in g["done"]] == [c.rid for c in e["done"]]
    for cg, ce in zip(g["done"], e["done"]):
        np.testing.assert_array_equal(cg.tokens, ce.tokens)
        np.testing.assert_allclose(cg.logits, ce.logits, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.cuda
def test_dense_measure_stream_replays_at_the_engines_bucket(card, tmp_path,
                                                            monkeypatch):
    """A biased GQA SMOKE stream under ``kernel_plan='measure'`` at the
    default bucket 0: the engine on the card takes its own (128; 3 buckets
    at ``max_len`` 300), every prefill replays with no plan made inside a
    capture, and the stream gives the eager (``nan_guard``) engine's
    tokens, logits within 1e-4 and the same flash launches, one a layer a
    prefill."""
    from repro_torch.compiler import registry
    from repro_torch.kernels import flash_attention
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    reqs = sched_mod.synthetic_workload(
        12, seed=7, prompt_lens=(2, 9, 30, 130, 200), new_tokens=(3, 5, 8),
        arrival_rate=2.0, vocab=256)
    out = {}
    for guard in (False, True):
        reg = obs.MetricsRegistry()
        old = obs.set_default_metrics(reg)
        old_reg = registry.set_default_registry(None)
        try:
            cfg = _cfg("qwen2-7b", bucket=0, kernel_plan="measure")
            model = convert.init_params(cfg,
                                        torch.Generator().manual_seed(0))
            gen = torch.Generator().manual_seed(11)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name.endswith((".wq.b", ".wk.b", ".wv.b")):
                        p.copy_(0.5 * torch.randn(p.shape, generator=gen))
            eng = Engine(cfg, model, ServeConfig(batch=4, max_len=300,
                                                 nan_guard=guard),
                         device=card)
            before = flash_attention.launches
            done = eng.serve_stream(reqs, collect_logits=True, max_slots=4,
                                    step_time_ms=1.0)
            torch.cuda.synchronize()
            out[guard] = dict(done=done,
                              launched=flash_attention.launches - before,
                              replays=eng._prefill.replays,
                              prefills=eng.stats()["phases"]["prefill"],
                              capture_plans=len(eng._reg._capture_memo),
                              counters=_counters(reg))
        finally:
            registry.set_default_registry(old_reg)
            obs.set_default_metrics(old)
        del eng
        gc.collect()
    g, e = out[False], out[True]
    assert g["counters"]["engine.prefill_graph_capture"] == 3
    assert not [k for k in g["counters"]
                if k.startswith(("engine.prefill_graph_eager",
                                 "engine.prefill_graph_capture_failed"))]
    assert g["capture_plans"] == 0
    n_prefills = g["prefills"]["steps"] + 1
    assert g["replays"] == n_prefills > 3
    assert e["replays"] == 0
    assert g["launched"] == e["launched"] == 2 * n_prefills
    assert [c.rid for c in g["done"]] == [c.rid for c in e["done"]]
    for cg, ce in zip(g["done"], e["done"]):
        np.testing.assert_array_equal(cg.tokens, ce.tokens)
        np.testing.assert_allclose(cg.logits, ce.logits, rtol=1e-4,
                                   atol=1e-4)
