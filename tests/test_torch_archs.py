"""The port's copies of the last decoder-only reference configs against the
JAX package: qwen2-7b, qwen2.5-14b and granite-3-2b (dense GQA),
deepseek-v3-671b (MLA with q compression, 256 routed experts, an MTP
block) and zamba2-2.7b (the hybrid family: groups of Mamba-2 blocks, each
followed by one shared attention + SwiGLU block).

For each config at SMOKE size: ``CONFIG`` and ``SMOKE`` equal the
reference's field for field; ``from_jax_params`` loads the reference's own
``init_params`` tree with ``strict=True`` (``shared_attn`` and ``mtp``
included); forward logits and a cached prefill followed by decode steps
agree within 1e-5, as the other SMOKE models do (XLA and torch order their
fp32 sums differently, a few 1e-6 after the unembed); and the greedy
tokens of ``Engine.generate`` are identical to the JAX engine's on the
kernel route (``pallas``; the ragged grouped GEMM for deepseek-v3) and on
the plain one, both impls for zamba2, and for zamba2 under
``kernel_plan='measure'`` too.  whisper-base and internvl2-2b (the
enc-dec and VLM families) are checked here where no decoder-only model is
needed: configs equal the reference's, they load, and every leaf of their
reference trees loads strict.  The qwen2 configs run with nonzero seeded
q / k / v biases (the reference initialises them to zeros).  Everything
runs in fp32 on the CPU, where the ops take their plain versions and no
kernel launches.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.kernels import decode_attention as port_da  # noqa: E402
from repro_torch.kernels import flash_attention as port_fa  # noqa: E402
from repro_torch.kernels import grouped_gemm as port_gg  # noqa: E402
from repro_torch.kernels import ssd_decode as port_sd  # noqa: E402
from repro_torch.kernels import ssd_scan as port_ss  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402
from torch_config_parity import assert_config_mirrors  # noqa: E402

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
# the caches: a KV or compressed MLA cache at the attention ops' 5e-6, a
# Mamba-2 state at the SSM slice's rtol 2e-5 (tests/test_torch_ssm.py)
CACHE_TOL = {"k": dict(rtol=5e-6, atol=5e-6),
             "c_kv": dict(rtol=5e-6, atol=5e-6),
             "state": dict(rtol=2e-5, atol=5e-6)}
BATCH, PROMPT, STEPS = 2, 8, 6

ARCHS = ("qwen2-7b", "qwen2.5-14b", "granite-3-2b", "deepseek-v3-671b",
         "zamba2-2.7b")
# the enc-dec and VLM configs: checked here where a test needs no
# decoder-only model (tests/test_torch_encdec.py and
# tests/test_torch_multimodal.py hold their models)
ITEM5_ARCHS = ("whisper-base", "internvl2-2b")
RAGGED = dict(ragged_dropless=True, inference_capacity_factor=0.0)
DENSE = dict(ragged_dropless=False, inference_capacity_factor=0.0)


# (arch, route): (port config fields, reference config fields).  The kernel
# route of the dense configs is attention_impl='pallas'; of deepseek-v3 the
# ragged grouped GEMM, against the reference's dense dropless route (its
# jitted engine always takes that one: ROADMAP.md queue 3); of zamba2 both
# impls at 'pallas'.  The reference runs its kernels on direct plans.
ROUTES = {}
for _a in ("qwen2-7b", "qwen2.5-14b", "granite-3-2b"):
    ROUTES[_a, "pallas"] = ({"attention_impl": "pallas"},) * 2
    ROUTES[_a, "plain"] = ({"attention_impl": "xla_chunked"},) * 2
ROUTES["deepseek-v3-671b", "pallas"] = (
    {"attention_impl": "pallas", "moe": RAGGED},
    {"attention_impl": "pallas", "moe": DENSE})
ROUTES["deepseek-v3-671b", "plain"] = ({"moe": DENSE},) * 2
ROUTES["zamba2-2.7b", "pallas"] = (
    {"attention_impl": "pallas", "ssm_impl": "pallas"},) * 2
ROUTES["zamba2-2.7b", "plain"] = (
    {"attention_impl": "xla_chunked", "ssm_impl": "xla"},) * 2


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))


def _modname(arch):
    return arch.replace("-", "_").replace(".", "_")


def _ref_module(arch):
    return importlib.import_module(f"repro.configs.{_modname(arch)}")


def _port_module(arch):
    return importlib.import_module(f"repro_torch.configs.{_modname(arch)}")


def _configure(cfg, fields, kernel_plan=None):
    fields = dict(fields)
    moe = fields.pop("moe", None)
    if moe is not None:
        cfg = dataclasses.replace(cfg,
                                  moe=dataclasses.replace(cfg.moe, **moe))
    if kernel_plan:
        fields["kernel_plan"] = kernel_plan
    return dataclasses.replace(cfg, **fields)


def _configs(arch, route):
    """(reference SMOKE on its direct plans, port SMOKE) for a route."""
    pf, jf = ROUTES[arch, route]
    return (_configure(_ref_module(arch).SMOKE, jf, "direct"),
            _configure(load_arch(arch, smoke=True), pf))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's ``init_params(SMOKE)`` (qwen2: with nonzero seeded
    q / k / v biases), as (JAX params, numpy tree, port model); the
    family's own init through the reference's ``models.model``."""
    from repro.models import model as jax_model
    jcfg = _ref_module(arch).SMOKE
    tree = jax.tree.map(np.asarray,
                        jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(11)
        for name in ("wq", "wk", "wv"):
            lin = tree["blocks"]["attn"][name]
            lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.5).astype(
                np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    return params, tree, convert.from_jax_params(load_arch(arch, smoke=True),
                                                 tree)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.int32)


def _launches():
    return (port_fa.launches, port_da.launches, port_ss.launches,
            port_sd.launches, port_gg.launches)


def _leaf(tree, name):
    """The tree's leaf for a port parameter name: ``blocks.3.attn.wq.w`` is
    ``tree["blocks"]["attn"]["wq"]["w"][3]`` (a scanned segment's layer
    axis comes first), ``shared_attn.attn.wq.w`` is not stacked."""
    node, layer = tree, None
    for part in name.split("."):
        if part.isdigit():
            layer = int(part)
        else:
            node = node[part]
    return node if layer is None else node[layer]


# ------------------------------------------------------------------ config --
@pytest.mark.parametrize("arch", ARCHS + ITEM5_ARCHS)
def test_config_mirrors_reference(arch):
    port, ref = _port_module(arch), _ref_module(arch)
    for name in ("CONFIG", "SMOKE"):
        p, r = getattr(port, name), getattr(ref, name)
        # the port defaults to the direct route, the reference to measured
        # plans (ROADMAP.md queue 3, divergences)
        assert (p.kernel_plan, r.kernel_plan) == ("direct", "measure")
        assert_config_mirrors(p, r, name)
    assert load_arch(arch) is port.CONFIG
    assert load_arch(arch, smoke=True) is port.SMOKE
    assert port.CONFIG.activation_dtype == torch.bfloat16
    assert port.SMOKE.activation_dtype == torch.float32


@pytest.mark.parametrize("arch", ITEM5_ARCHS)
def test_load_arch_loads_the_enc_dec_and_vlm_configs(arch):
    cfg = load_arch(arch)
    assert cfg is _port_module(arch).CONFIG
    assert cfg.family == {"whisper-base": "encdec",
                          "internvl2-2b": "vlm"}[arch]
    model = port_model.build(load_arch(arch, smoke=True))
    assert sum(p.numel() for p in model.parameters()) > 0
    with pytest.raises(ModuleNotFoundError, match="no_such_arch"):
        load_arch("no-such-arch")


# ------------------------------------------------------------------ params --
@pytest.mark.parametrize("arch", ARCHS + ITEM5_ARCHS)
def test_from_jax_params_loads_every_leaf(arch):
    params, tree, model = _weights(arch)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), _leaf(tree, name),
                                      err_msg=name)
    single = [k for k in ("shared_attn", "mtp") if k in tree]
    assert single == {"zamba2-2.7b": ["shared_attn"],
                      "deepseek-v3-671b": ["mtp"]}.get(arch, [])
    for k in single:   # strict: the tree without the block does not load
        cut = {key: v for key, v in tree.items() if key != k}
        with pytest.raises(RuntimeError, match="Missing key"):
            convert.from_jax_params(load_arch(arch, smoke=True), cut)


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2.5-14b"])
def test_qwen2_biases_are_seeded_and_move_the_logits(arch):
    _, tree, model = _weights(arch)
    cfg = load_arch(arch, smoke=True)
    assert cfg.qkv_bias
    for name in ("wq", "wk", "wv"):
        b = tree["blocks"]["attn"][name]["b"]
        assert np.abs(b).min() > 0
        np.testing.assert_array_equal(
            getattr(model.blocks[1].attn, name).b.numpy(), b[1])
    toks = torch.from_numpy(_tokens(5, (BATCH, 12))).long()
    tree0 = jax.tree.map(np.copy, tree)
    for name in ("wq", "wk", "wv"):
        tree0["blocks"]["attn"][name]["b"][:] = 0.0
    got, _ = port_model.forward(cfg, model, {"tokens": toks})
    no_bias, _ = port_model.forward(cfg, convert.from_jax_params(cfg, tree0),
                                    {"tokens": toks})
    assert float((no_bias - got).abs().max()) > 1e-3


# ------------------------------------------------------------------- model --
@pytest.mark.parametrize("arch,route", sorted(ROUTES))
def test_forward_logits_match(arch, route):
    from repro.models import transformer as jax_tf
    params, _, model = _weights(arch)
    jcfg, pcfg = _configs(arch, route)
    toks = _tokens(0, (BATCH, 12))
    want, want_aux = jax_tf.forward(jcfg, params, jnp.asarray(toks))
    before = _launches()
    got, aux = port_model.forward(pcfg, model,
                                  {"tokens": torch.from_numpy(toks).long()})
    assert _launches() == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("arch,route", sorted(ROUTES))
def test_cached_prefill_and_decode_match(arch, route):
    from repro.models import transformer as jax_tf
    params, _, model = _weights(arch)
    jcfg, pcfg = _configs(arch, route)
    toks = _tokens(1, (BATCH, PROMPT + STEPS))
    jstep = jax.jit(functools.partial(jax_tf.decode_step, jcfg))
    jcache = jax_tf.init_cache(jcfg, BATCH, PROMPT + STEPS, jnp.float32)
    pcache = port_model.init_cache(pcfg, BATCH, PROMPT + STEPS,
                                   torch.float32)
    assert sorted(pcache) == sorted(jcache)
    for lo, hi in [(0, PROMPT)] + [(i, i + 1)
                                    for i in range(PROMPT, PROMPT + STEPS)]:
        want, jcache = jstep(params, jnp.asarray(toks[:, lo:hi]), jcache)
        got, pcache = port_model.decode_step(
            pcfg, model, {"tokens": torch.from_numpy(toks[:, lo:hi]).long()},
            pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"tokens {lo}:{hi}", **LOGIT_TOL)
    for name, layers in pcache.items():
        assert len(layers) == jcache[name]["pos"].shape[0]
        for i, layer in enumerate(layers):
            assert layer["pos"] == PROMPT + STEPS
            leaf = next(k for k in ("k", "c_kv", "state") if k in layer)
            np.testing.assert_allclose(
                layer[leaf].numpy(), np.asarray(jcache[name][leaf][i]),
                err_msg=f"{name}[{i}].{leaf}", **CACHE_TOL[leaf])


@pytest.mark.parametrize("arch,route", sorted(ROUTES))
def test_greedy_tokens_match_reference_engine(arch, route):
    from repro.serve.engine import Engine, ServeConfig
    params, _, model = _weights(arch)
    jcfg, pcfg = _configs(arch, route)
    prompts = _tokens(2, (BATCH, PROMPT))
    max_len = PROMPT + STEPS + 1
    want = Engine(jcfg, params, ServeConfig(
        batch=BATCH, max_len=max_len, warmup=False, kernel_plan="direct")
    ).generate(jnp.asarray(prompts), STEPS)
    eng = port_engine.Engine(pcfg, model, port_engine.ServeConfig(
        batch=BATCH, max_len=max_len), device="cpu")
    before = _launches()
    got = eng.generate(torch.from_numpy(prompts).long(), STEPS)
    assert _launches() == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_zamba2_measure_route_matches_reference_engine():
    """zamba2 SMOKE under ``kernel_plan='measure'`` in both engines (each
    with a fresh registry of its own): identical greedy tokens, and the
    port's warmup plans all four serving kernels, after which every call
    is a hit."""
    from repro.compiler import registry as jax_reg
    from repro.serve.engine import Engine, ServeConfig
    from repro_torch import compiler
    from repro_torch.compiler import registry as port_reg
    arch = "zamba2-2.7b"
    jf = ROUTES[arch, "pallas"][1]
    jcfg = _configure(_ref_module(arch).SMOKE, jf)
    assert jcfg.kernel_plan == "measure"
    params, _, model = _weights(arch)
    prompts = _tokens(3, (BATCH, PROMPT))
    max_len = PROMPT + STEPS + 1
    old = jax_reg.set_default_registry(None)
    try:
        want = Engine(jcfg, params, ServeConfig(batch=BATCH, max_len=max_len)
                      ).generate(jnp.asarray(prompts), STEPS)
    finally:
        jax_reg.set_default_registry(old)
    compiler.clear_memo()
    old = port_reg.set_default_registry(None)
    try:
        _, pcfg = _configs(arch, "pallas")
        eng = port_engine.Engine(pcfg, model, port_engine.ServeConfig(
            batch=BATCH, max_len=max_len, kernel_plan="measure"),
            device="cpu")
        st0 = eng.stats()
        assert st0["warmup_failed"] == 0 and st0["plans_warmed"] > 0
        assert {r["kernel"] for r in eng.warmup_report} == {
            "flash_attention", "decode_attention", "ssd_scan", "ssd_decode"}
        misses = st0["registry"]["misses"]
        got = eng.generate(torch.from_numpy(prompts).long(), STEPS)
        st = eng.stats()["registry"]
        assert st["misses"] == misses and st["fallbacks"] == 0
        # a prefill and STEPS decode steps: one call per Mamba-2 block and
        # one per application of the shared block
        calls = pcfg.n_layers + pcfg.n_layers // pcfg.hybrid_attn_every
        assert st["hits"] == (1 + STEPS) * calls
    finally:
        port_reg.set_default_registry(old)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ hybrid --
def test_hybrid_cache_layout_and_one_shared_block():
    """zamba2 SMOKE (4 Mamba-2 blocks, the shared block every 2): a cache of
    4 Mamba-2 states and 2 GQA caches of the shared block, one per group;
    the shared block's weights exist once, and every group reads them."""
    cfg = load_arch("zamba2-2.7b", smoke=True)
    _, tree, model = _weights("zamba2-2.7b")
    cache = port_model.init_cache(cfg, BATCH, 16, torch.float32)
    assert list(cache) == ["blocks", "shared_attn"]
    assert len(cache["blocks"]) == cfg.n_layers == 4
    assert len(cache["shared_attn"]) == cfg.n_layers // cfg.hybrid_attn_every \
        == 2
    for layer in cache["blocks"]:
        assert sorted(layer) == ["conv", "pos", "state"]
    hd = cfg.d_model // cfg.n_heads
    for layer in cache["shared_attn"]:
        assert sorted(layer) == ["k", "pos", "v"]
        assert tuple(layer["k"].shape) == (BATCH, cfg.n_kv_heads, 16, hd)
    assert cache["shared_attn"][0]["k"] is not cache["shared_attn"][1]["k"]
    names = [n for n, _ in model.named_parameters()]
    assert sum(n.startswith("shared_attn.") for n in names) == len(
        jax.tree.leaves(tree["shared_attn"]))
    assert not any(n.startswith("blocks.") and ".attn." in n for n in names)
    # each group's shared block writes its own cache, with its own keys
    toks = torch.from_numpy(_tokens(4, (BATCH, PROMPT))).long()
    _, cache = port_model.decode_step(cfg, model, {"tokens": toks}, cache)
    k0, k1 = (c["k"][:, :, :PROMPT] for c in cache["shared_attn"])
    assert float(k0.abs().max()) > 0 and not torch.equal(k0, k1)
    assert [c["pos"] for c in cache["shared_attn"]] == [PROMPT, PROMPT]
    # and the shared block is read by every group: its weights move the
    # logits, and zeroing its output projection equals a stack without it
    tree0 = jax.tree.map(np.copy, tree)
    tree0["shared_attn"]["attn"]["wo"]["w"][:] = 0.0
    tree0["shared_attn"]["mlp"]["down"]["w"][:] = 0.0
    no_shared = convert.from_jax_params(cfg, tree0)
    got, _ = port_model.forward(cfg, model, {"tokens": toks})
    skip, _ = port_model.forward(cfg, no_shared, {"tokens": toks})
    ssm_only, _ = port_model.forward(dataclasses.replace(
        cfg, hybrid_attn_every=0), model, {"tokens": toks})
    assert float((skip - got).abs().max()) > 1e-3
    torch.testing.assert_close(skip, ssm_only, rtol=0, atol=0)


def test_deepseek_v3_mtp_block_is_carried_but_not_served():
    """The MTP block loads with the tree (reference ``init_params``) and,
    as in the reference's forward and decode step, no serving path reads
    it: zeroing its weights changes no logit."""
    cfg = load_arch("deepseek-v3-671b", smoke=True)
    assert cfg.mtp_depth == 1 and cfg.mla.q_lora_rank
    _, tree, model = _weights("deepseek-v3-671b")
    tree0 = jax.tree.map(np.copy, tree)
    for leaf in jax.tree.leaves(tree0["mtp"]):
        leaf[...] = 0.0
    zeroed = convert.from_jax_params(cfg, tree0)
    toks = torch.from_numpy(_tokens(6, (BATCH, PROMPT))).long()
    a, _ = port_model.forward(cfg, model, {"tokens": toks})
    b, _ = port_model.forward(cfg, zeroed, {"tokens": toks})
    assert torch.equal(a, b)
    ca = port_model.init_cache(cfg, BATCH, PROMPT, torch.float32)
    cb = port_model.init_cache(cfg, BATCH, PROMPT, torch.float32)
    a, _ = port_model.decode_step(cfg, model, {"tokens": toks}, ca)
    b, _ = port_model.decode_step(cfg, zeroed, {"tokens": toks}, cb)
    assert torch.equal(a, b)


# ----------------------------------------------- the kernels at full width --
@pytest.mark.parametrize("arch,group,d", [("qwen2-7b", 7, 128),
                                          ("qwen2.5-14b", 5, 128),
                                          ("granite-3-2b", 4, 64),
                                          ("zamba2-2.7b", 1, 80)])
def test_full_width_attention_plans_and_built_kernels(arch, group, d):
    """The Engine's plan grid at each CONFIG's serving shape asks for flash
    and decode attention at the config's head group and width (zamba2's D
    80 from 2560 / 32 heads), both of which the kernels are built for at
    T1 (decode: a group of 7 fills 7 of a lane's 8 slots), with an fp32
    cache; zamba2 adds the SSD scan and decode step at N 64, H 80."""
    cfg = dataclasses.replace(load_arch(arch), attention_impl="pallas",
                              ssm_impl="pallas", fresh_prefill_kernel=True)
    reqs = port_tf.plan_requests(cfg, 8, 577, dtype="bfloat16", cached=True,
                                 cache_dtype=torch.float32)
    kinds = {}
    for kernel, kw in reqs:
        kinds.setdefault(kernel, []).append(kw)
    assert {kw["d"] for kw in kinds["flash_attention"]} == {d}
    assert {kw["h"] // kw["hkv"] for kw in kinds["decode_attention"]} == {
        group}
    assert {kw["d"] for kw in kinds["decode_attention"]} == {d}
    assert port_fa.built(1, "T", d, torch.bfloat16)
    assert port_da.built(1, "T", group, d, torch.float32)
    assert port_da.lane_slots(group, d) <= port_da.MAX_LANE_SLOTS
    if arch == "zamba2-2.7b":
        assert port_fa.padded_dim(d) == 128
        (scan,) = {(kw["h"], kw["n"], kw["p"], kw["chunk"])
                   for kw in kinds["ssd_scan"]}
        assert scan == (80, 64, 64, 64)
        (step,) = kinds["ssd_decode"]
        assert (step["h"], step["n"], step["p"]) == (80, 64, 64)
        assert port_ss.built(1, "T")
    else:
        assert set(kinds) == {"flash_attention", "decode_attention"}


# -------------------------------------------------------------- launchers --
def test_serve_cli_runs_hybrid_on_cpu(capsys):
    from repro_torch.launch import serve
    before = _launches()
    out = serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                      "--attention-impl", "pallas", "--ssm-impl", "pallas",
                      "--batch", "2", "--prompt-len", "9", "--new", "4"])
    assert tuple(out.shape) == (2, 4)
    assert _launches() == before
    assert "zamba2-smoke on cpu (attention pallas, SSM pallas)" in \
        capsys.readouterr().out
