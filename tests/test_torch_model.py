"""The port's dense model against the JAX reference on the same weights.

The weights are the reference's own ``init_params(SMOKE)``, handed across
as numpy arrays through ``convert.from_jax_params``.  Everything runs in
fp32 on the CPU, the port through its plain attention.  Logits are held to
1e-5: XLA and torch order the matmul sums differently on the CPU, which
shows up as at most about 5e-7 on these logits (|logit| < 0.7) after two
layers and the unembed; the bound leaves a 20x margin and stays well
inside the 1e-4 the port may never exceed.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.configs import qwen3_0_6b as port_qwen3  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from torch_config_parity import assert_config_mirrors  # noqa: E402

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT, STEPS, BATCH = 8, 8, 2


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))


def _configs():
    from repro.configs import qwen3_0_6b as jax_qwen3
    # the reference's kernel route, on its direct (registry-free) plans
    jcfg = dataclasses.replace(jax_qwen3.SMOKE, attention_impl="pallas",
                               kernel_plan="direct",
                               fresh_prefill_kernel=True)
    pcfg = dataclasses.replace(port_qwen3.SMOKE, attention_impl="pallas",
                               fresh_prefill_kernel=True)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def weights():
    from repro.models import transformer as jax_tf
    from repro.configs import qwen3_0_6b as jax_qwen3
    params = jax_tf.init_params(jax_qwen3.SMOKE, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return params, convert.from_jax_params(port_qwen3.SMOKE, tree)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def test_config_mirrors_reference():
    from repro.configs import qwen3_0_6b as jax_qwen3
    for name in ("CONFIG", "SMOKE"):
        ref, port = getattr(jax_qwen3, name), getattr(port_qwen3, name)
        # kernel_plan: a recorded divergence (below)
        assert_config_mirrors(port, ref, name)
        # the port defaults to the direct route, the reference to measured
        # plans (ROADMAP.md queue 3, divergences)
        assert (port.kernel_plan, ref.kernel_plan) == ("direct", "measure")
    assert port_qwen3.SMOKE.activation_dtype == torch.float32
    assert port_qwen3.CONFIG.activation_dtype == torch.bfloat16


def test_from_jax_params_loads_every_leaf(weights):
    params, model = weights
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    np.testing.assert_array_equal(
        model.blocks[1].attn.wq.w.numpy(),
        np.asarray(params["blocks"]["attn"]["wq"]["w"][1]))


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_logits_match(weights, last_only):
    from repro.models import transformer as jax_tf
    params, model = weights
    jcfg, pcfg = _configs()
    toks = _tokens(0, (BATCH, 12), pcfg.vocab_size)
    want, _ = jax_tf.forward(jcfg, params, jnp.asarray(toks),
                             last_only=last_only)
    got, _ = port_model.forward(pcfg, model,
                                {"tokens": torch.from_numpy(toks).long()},
                                last_only=last_only)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_cached_prefill_and_decode_match(weights):
    from repro.models import transformer as jax_tf
    params, model = weights
    jcfg, pcfg = _configs()
    max_len = PROMPT + STEPS + 1
    toks = _tokens(1, (BATCH, PROMPT + STEPS), pcfg.vocab_size)

    jstep = jax.jit(functools.partial(jax_tf.decode_step, jcfg))
    jcache = jax_tf.init_cache(jcfg, BATCH, max_len, jnp.float32)
    pcache = port_model.init_cache(pcfg, BATCH, max_len, torch.float32)
    want, jcache = jstep(params, jnp.asarray(toks[:, :PROMPT]), jcache)
    got, pcache = port_model.decode_step(
        pcfg, model, {"tokens": torch.from_numpy(toks[:, :PROMPT]).long()},
        pcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for i in range(PROMPT, PROMPT + STEPS):
        want, jcache = jstep(params, jnp.asarray(toks[:, i:i + 1]), jcache)
        got, pcache = port_model.decode_step(
            pcfg, model, {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()},
            pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"decode step at pos {i}",
                                   **LOGIT_TOL)
    assert pcache["blocks"][0]["pos"] == PROMPT + STEPS
    np.testing.assert_allclose(
        pcache["blocks"][1]["k"].numpy(),
        np.asarray(jcache["blocks"]["k"][1]), **LOGIT_TOL)


@pytest.mark.parametrize("valid", [[True] * 24, [False] * 24,
                                   [False] * 5 + [True] * 19])
@pytest.mark.parametrize("causal,block", [(True, 8), (False, 7), (True, 64)])
def test_chunked_attention_matches(valid, causal, block):
    """Including fully masked rows (an all-False kv_mask, and rows whose
    causal prefix is all masked), where NEG_INF = -1e30 makes the softmax a
    uniform average, and a block that leaves a padded tail."""
    from repro.models import attention as jax_attn
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 24, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, 24, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, 24, 32)).astype(np.float32)
    mask = np.array(valid)
    want = jax_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_mask=jnp.asarray(mask), block=block)
    got = port_attn.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_mask=torch.from_numpy(mask), block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=5e-6, atol=5e-6)


@pytest.mark.parametrize("arch,family", [("whisper-base", "encdec"),
                                         ("internvl2-2b", "vlm")])
def test_every_family_builds_and_loads(arch, family):
    """The enc-dec and VLM families build (``model.build``) and load the
    reference's own ``init_params`` tree strictly, leaf for leaf; a family
    the reference lacks raises."""
    import importlib
    from repro.models import model as jax_model
    from repro_torch.configs.base import load_arch
    from repro_torch.models import encdec, multimodal
    cfg = load_arch(arch, smoke=True)
    assert cfg.family == family
    built = port_model.build(cfg)
    assert isinstance(built, {"encdec": encdec.EncDec,
                              "vlm": multimodal.VLM}[family])
    jcfg = importlib.import_module(
        f"repro.configs.{arch.replace('-', '_')}").SMOKE
    tree = jax.tree.map(np.asarray,
                        jax_model.init_params(jcfg, jax.random.PRNGKey(1)))
    model = convert.from_jax_params(cfg, tree)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    with pytest.raises(ValueError, match="unknown family"):
        port_model.build(dataclasses.replace(cfg, family="audio"))


@pytest.mark.parametrize("impl", ["pallas", "xla_chunked"])
def test_biased_gqa_matches_reference(impl):
    """A SMOKE GQA model with ``qkv_bias=True`` whose q / k / v biases are
    seeded nonzero numpy values (the reference initialises them to zeros,
    which would check nothing), carried across with ``from_jax_params``:
    the forward logits within LOGIT_TOL and the engine's greedy tokens
    identical to the JAX engine's."""
    from repro.configs import qwen3_0_6b as jax_qwen3
    from repro.models import transformer as jax_tf
    from repro.serve.engine import Engine, ServeConfig
    from repro_torch.serve import engine as port_engine
    jcfg = dataclasses.replace(jax_qwen3.SMOKE, qkv_bias=True,
                               attention_impl=impl)
    pcfg = dataclasses.replace(port_qwen3.SMOKE, qkv_bias=True,
                               attention_impl=impl)
    tree = jax.tree.map(np.asarray,
                        jax_tf.init_params(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(11)
    for name in ("wq", "wk", "wv"):
        lin = tree["blocks"]["attn"][name]
        assert not lin["b"].any()
        lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.5).astype(
            np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    model = convert.from_jax_params(pcfg, tree)
    np.testing.assert_array_equal(model.blocks[1].attn.wk.b.numpy(),
                                  tree["blocks"]["attn"]["wk"]["b"][1])

    toks = _tokens(5, (BATCH, 12), pcfg.vocab_size)
    want, _ = jax_tf.forward(jcfg, params, jnp.asarray(toks))
    got, _ = port_model.forward(pcfg, model,
                                {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    # the biases move the logits: the same weights without them differ
    tree0 = jax.tree.map(np.copy, tree)
    for name in ("wq", "wk", "wv"):
        tree0["blocks"]["attn"][name]["b"][:] = 0.0
    no_bias, _ = port_model.forward(pcfg, convert.from_jax_params(pcfg, tree0),
                                    {"tokens": torch.from_numpy(toks).long()})
    assert float((no_bias - got).abs().max()) > 1e-3

    prompts = toks[:, :PROMPT]
    max_len = PROMPT + STEPS + 1
    want_toks = Engine(jcfg, params, ServeConfig(
        batch=BATCH, max_len=max_len, warmup=False, kernel_plan="direct")
    ).generate(jnp.asarray(prompts), STEPS)
    eng = port_engine.Engine(pcfg, model, port_engine.ServeConfig(
        batch=BATCH, max_len=max_len), device="cpu")
    got_toks = eng.generate(torch.from_numpy(prompts).long(), STEPS)
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
