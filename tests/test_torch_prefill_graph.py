"""The engine's fresh prefill replayed per length bucket as a CUDA graph
(``repro_torch.serve.prefill_graph``).

On the CPU: the buckets, the rule that decides when a prefill may replay,
and the padded prefill (each bucket's backbone run eagerly into the static
buffers, ``warm(capture=False)``) against the eager, unpadded one: logits
and every cache row, for a GQA and an MLA + MoE model.  On the card
(marked ``cuda``): a deepseek SMOKE stream whose prefills replay gives the
eager stream's tokens, its logits within rounding, and the same grouped
GEMM launches.
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
     dict(cfg=dict(moe=dict(inference_capacity_factor=2.0))), False, None),
], ids=["dense", "off", "ssm", "hybrid", "mesh", "nan_guard", "faults",
        "per_slot", "moe_registry", "moe_ragged_direct", "moe_capacity"])
def test_engage_rule(arch, kw, per_slot, want):
    """A fresh int-pos cache of K/V or MLA rows, in the dense or MoE
    family, unguarded, off any mesh and off the MoE registry route, under
    a bucket > 0, may replay; every other prefill is eager with its
    reason."""
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
    max_len 48) and the stream gives the eager prefills' tokens, logits
    within rounding and the same grouped GEMM launches."""
    reqs = sched_mod.synthetic_workload(
        12, seed=7, prompt_lens=(2, 5, 9, 14, 30), new_tokens=(3, 5, 8),
        arrival_rate=2.0, vocab=256)
    out = {}
    for bucket in (16, 0):
        reg = obs.MetricsRegistry()
        old = obs.set_default_metrics(reg)
        try:
            cfg = _cfg("deepseek-v2-lite-16b", bucket=bucket)
            model = convert.init_params(cfg,
                                        torch.Generator().manual_seed(0))
            eng = Engine(cfg, model, ServeConfig(batch=4, max_len=48),
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
