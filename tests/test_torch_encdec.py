"""The port's enc-dec family (whisper-base) and the layers it brings
against the JAX package, on the CPU in fp32 (SMOKE), where the ops take
their plain versions and no kernel launches.

* ``layernorm`` (fp32 and bf16 inputs) and ``gelu_mlp`` (fp32) within
  5e-6 of the reference; the erf GELU misses that tolerance by some 100x,
  so the tanh form (JAX's default) is pinned.  In bf16 the GELU MLP is
  not held to JAX's: XLA rounds the GELU's intermediates to bf16, torch's
  ``F.gelu`` rounds once, a bf16 ulp apart.
* ``gqa_apply`` as cross-attention (``kv_input``, S != T, GQA 4/2) and
  non-causal, within 5e-6, on both ``attention_impl`` values (the JAX
  kernel route runs its Pallas flash kernel in interpret mode).
* ``encode``, ``forward`` and ``decode`` with and without a cache within
  1e-5 (XLA and torch order their fp32 sums differently; these logits
  differ by a few 1e-7), on both routes.
* ``from_jax_params`` loads every leaf of the reference's tree, the
  parameter count is the reference's, and ``init_params`` draws the
  reference's shapes and distributions.
* ``Engine.generate(..., enc_out=...)`` and ``prefill_chunk`` against the
  JAX engine's: identical greedy tokens, logits within 1e-5.
* Continuous batching refuses the family (scheduler, per-slot cache, the
  launcher's stream mode) with the reference's messages; the launcher
  serves whisper-base SMOKE.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.kernels import decode_attention as port_da  # noqa: E402
from repro_torch.kernels import flash_attention as port_fa  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import encdec as port_encdec  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402

OP_TOL = dict(rtol=5e-6, atol=5e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, PROMPT, NEW = 2, 8, 4
IMPLS = ("pallas", "xla_chunked")


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _launches():
    return port_fa.launches, port_da.launches


# ------------------------------------------------------------------ layers --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    from repro.models import layers as jl
    x = _normal(0, (2, 8, 64), 3.0) + 1.5
    p = {"scale": _normal(1, (64,)), "bias": _normal(2, (64,))}
    want = jl.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x).astype(dtype), 1e-5)
    mod = port_layers.LayerNorm(64).requires_grad_(False)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    got = port_layers.layernorm(mod, torch.from_numpy(x).to(
        getattr(torch, dtype)), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **OP_TOL)


def test_gelu_mlp_matches_reference():
    from repro.models import layers as jl
    tree = jax.tree.map(np.asarray, jl.gelu_mlp_init(jax.random.PRNGKey(0),
                                                     32, 64))
    tree["up"]["b"] = _normal(3, (64,), 0.5)
    tree["down"]["b"] = _normal(4, (32,), 0.5)
    x = _normal(5, (2, 8, 32))
    want = jl.gelu_mlp(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    mod = port_layers.GeluMLP(32, 64).requires_grad_(False)
    mod.load_state_dict({k: torch.from_numpy(v)
                         for k, v in _flatten(tree).items()})
    got = port_layers.gelu_mlp(mod, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation: the port's
    ``gelu`` is within 5e-6 of it, the erf form is not."""
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    t = torch.from_numpy(x)
    np.testing.assert_allclose(port_layers.gelu(t).numpy(), want, **OP_TOL)
    erf = torch.nn.functional.gelu(t).numpy()
    assert np.abs(erf - want).max() > 50 * OP_TOL["atol"]


# --------------------------------------------------------------- attention --
def _gqa_pair(cfg_name, seed=0):
    """(reference GQA params, port GQA) of a SMOKE config, with seeded
    nonzero q / k / v biases where the config has them."""
    import importlib
    from repro.models import attention as jattn
    jcfg = importlib.import_module(f"repro.configs.{cfg_name}").SMOKE
    tree = jax.tree.map(np.asarray, jattn.gqa_init(jax.random.PRNGKey(seed),
                                                   jcfg))
    pcfg = importlib.import_module(f"repro_torch.configs.{cfg_name}").SMOKE
    mod = port_attn.GQA(pcfg).requires_grad_(False)
    mod.load_state_dict({k: torch.from_numpy(v)
                         for k, v in _flatten(tree).items()})
    return jcfg, jax.tree.map(jnp.asarray, tree), pcfg, mod


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("cfg_name", ["internvl2_2b", "qwen3_0_6b"])
def test_cross_attention_matches_reference(impl, cfg_name):
    """S 5 queries over T 11 keys, GQA 4/2 (qwen3: with qk_norm): no rope,
    no mask, the plain route on both impls."""
    from repro.models import attention as jattn
    jcfg, params, pcfg, mod = _gqa_pair(cfg_name)
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    pcfg = dataclasses.replace(pcfg, attention_impl=impl)
    assert (pcfg.n_heads, pcfg.n_kv_heads) == (4, 2)
    x, kv = _normal(6, (2, 5, 64)), _normal(7, (2, 11, 64))
    pos = np.arange(3, 8)
    want, _ = jattn.gqa_apply(params, jcfg, jnp.asarray(x),
                              positions=jnp.asarray(pos),
                              kv_input=jnp.asarray(kv))
    before = _launches()
    got, cache = port_attn.gqa_apply(mod, pcfg, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos),
                                     kv_input=torch.from_numpy(kv))
    assert cache is None and _launches() == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    # the positions reach no rope: other positions give the same answer
    again, _ = port_attn.gqa_apply(mod, pcfg, torch.from_numpy(x),
                                   positions=torch.arange(5),
                                   kv_input=torch.from_numpy(kv))
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no cache"):
        port_attn.gqa_apply(mod, pcfg, torch.from_numpy(x),
                            positions=torch.from_numpy(pos),
                            kv_input=torch.from_numpy(kv),
                            cache=port_attn.gqa_cache_init(pcfg, 2, 8))


@pytest.mark.parametrize("impl", IMPLS)
def test_non_causal_self_attention_matches_reference(impl):
    """The encoder's self-attention: rope, no mask, S 13 (no tile
    multiple), GQA 4/2; the kernel route reaches flash, non-causal."""
    from repro.models import attention as jattn
    jcfg, params, pcfg, mod = _gqa_pair("internvl2_2b", seed=1)
    jcfg = dataclasses.replace(jcfg, attention_impl=impl,
                               kernel_plan="direct")
    pcfg = dataclasses.replace(pcfg, attention_impl=impl)
    x = _normal(8, (2, 13, 64))
    want, _ = jattn.gqa_apply(params, jcfg, jnp.asarray(x),
                              positions=jnp.arange(13), causal=False)
    got, _ = port_attn.gqa_apply(mod, pcfg, torch.from_numpy(x),
                                 positions=torch.arange(13), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OP_TOL)
    causal, _ = port_attn.gqa_apply(mod, pcfg, torch.from_numpy(x),
                                    positions=torch.arange(13))
    assert float((causal - got).abs().max()) > 1e-3


# ------------------------------------------------------------------- model --
def _configs(impl):
    """(reference SMOKE on direct plans, port SMOKE) at ``impl``."""
    from repro.configs import whisper_base as jw
    return (dataclasses.replace(jw.SMOKE, attention_impl=impl,
                                kernel_plan="direct"),
            dataclasses.replace(load_arch("whisper-base", smoke=True),
                                attention_impl=impl))


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's ``init_params(SMOKE)`` with seeded nonzero
    LayerNorm and MLP biases and LayerNorm scales (the reference
    initialises them to zeros and ones, which would check nothing), as
    (JAX params, numpy tree, port model)."""
    from repro.configs import whisper_base as jw
    from repro.models import model as jm
    tree = jax.tree.map(np.array, jm.init_params(jw.SMOKE,
                                                   jax.random.PRNGKey(0)))
    rng = np.random.default_rng(17)
    for name, leaf in _flatten(tree).items():
        if name.endswith(".bias") or name.endswith(".b"):
            leaf[...] = rng.standard_normal(leaf.shape) * 0.1
        elif name.endswith(".scale"):
            leaf[...] = 1.0 + rng.standard_normal(leaf.shape) * 0.1
    return (jax.tree.map(jnp.asarray, tree), tree,
            convert.from_jax_params(load_arch("whisper-base", smoke=True),
                                    tree))


def _frames(seed=9):
    cfg = load_arch("whisper-base", smoke=True)
    return _normal(seed, (BATCH, cfg.encoder_seq, cfg.d_model))


@functools.lru_cache(maxsize=None)
def _encoded(impl):
    """Both packages' encoder outputs on the same frames."""
    from repro.models import encdec as je
    params, _, model = _weights()
    jcfg, pcfg = _configs(impl)
    fr = _frames()
    return (je.encode(jcfg, params, jnp.asarray(fr)),
            port_encdec.encode(pcfg, model, torch.from_numpy(fr)))


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_reference(impl):
    want, got = _encoded(impl)
    cfg = load_arch("whisper-base", smoke=True)
    assert tuple(got.shape) == (BATCH, cfg.encoder_seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_sinusoid_matches_reference_table():
    """Rows computed at their positions equal the reference's table
    (``_sinusoid(2**15, d)[positions]``) at the decoder's depths."""
    from repro.models import encdec as je
    pos = np.array([0, 1, 7, 31, 447, 1499, 4096], np.int64)
    want = np.asarray(je._sinusoid(int(2 ** 15), 64))[pos]
    got = port_encdec.sinusoid(torch.from_numpy(pos), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(impl):
    from repro.models import model as jm
    params, _, model = _weights()
    jcfg, pcfg = _configs(impl)
    fr, toks = _frames(), _tokens(1, (BATCH, 12))
    want, want_aux = jm.forward(jcfg, params, {
        "frames": jnp.asarray(fr), "tokens": jnp.asarray(toks)})
    before = _launches()
    got, aux = port_model.forward(pcfg, model, {
        "frames": torch.from_numpy(fr), "tokens": torch.from_numpy(toks)})
    assert _launches() == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert float(aux) == float(want_aux) == 0.0
    last, _ = port_model.forward(pcfg, model, {
        "frames": torch.from_numpy(fr), "tokens": torch.from_numpy(toks)},
        last_only=True)
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_with_and_without_cache_matches_reference(impl):
    """The cache-free decode over 12 tokens; then a fresh-cache prefill of
    8 and 4 single steps, each against the reference's stacked cache."""
    from repro.models import encdec as je
    params, _, model = _weights()
    jcfg, pcfg = _configs(impl)
    jenc, penc = _encoded(impl)
    toks = _tokens(2, (BATCH, PROMPT + NEW))
    want, _ = je.decode(jcfg, params, jnp.asarray(toks), jenc)
    got, none = port_encdec.decode(pcfg, model, torch.from_numpy(toks), penc)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)

    jcfg = dataclasses.replace(jcfg, fresh_prefill_kernel=True)
    pcfg = dataclasses.replace(pcfg, fresh_prefill_kernel=True)
    jcache = je.init_cache(jcfg, BATCH, PROMPT + NEW, jnp.float32)
    pcache = port_model.init_cache(pcfg, BATCH, PROMPT + NEW, torch.float32)
    assert isinstance(pcache, list) and len(pcache) == pcfg.n_layers
    for lo, hi in [(0, PROMPT)] + [(i, i + 1)
                                    for i in range(PROMPT, PROMPT + NEW)]:
        chunk = toks[:, lo:hi]
        w, jcache = je.decode_step(jcfg, params, jnp.asarray(chunk), jenc,
                                   jcache)
        g, pcache = port_model.decode_step(
            pcfg, model, {"tokens": torch.from_numpy(chunk),
                          "enc_out": penc}, pcache)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=f"tokens {lo}:{hi}", **LOGIT_TOL)
        if hi - lo > 1:    # last_only: the final position alone
            g1, _ = port_encdec.decode(
                pcfg, model, torch.from_numpy(chunk), penc,
                port_model.init_cache(pcfg, BATCH, PROMPT + NEW,
                                      torch.float32), last_only=True)
            assert g1.shape[1] == 1
            np.testing.assert_allclose(g1.numpy(), g[:, -1:].numpy(),
                                       rtol=0, atol=1e-6)
    for i, layer in enumerate(pcache):
        assert layer["pos"] == PROMPT + NEW
        np.testing.assert_allclose(layer["k"].numpy(),
                                   np.asarray(jcache["k"][i]), **OP_TOL)


# ------------------------------------------------------------------ params --
def test_from_jax_params_loads_every_leaf():
    params, tree, model = _weights()
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    flat = _flatten(tree)
    names = model.state_dict()
    cfg = load_arch("whisper-base", smoke=True)
    for name, t in names.items():
        parts = name.split(".")
        if parts[0] in ("enc_blocks", "dec_blocks"):
            want = flat[".".join([parts[0]] + parts[2:])][int(parts[1])]
        else:
            want = flat[name]
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
    assert {n.split(".")[0] for n in names} == {
        "frontend_proj", "enc_blocks", "enc_norm", "embed", "dec_blocks",
        "dec_norm"}
    assert len(model.enc_blocks) == cfg.n_encoder_layers
    assert len(model.dec_blocks) == cfg.n_layers
    # strict: a tree without the decoder's final norm does not load
    cut = {k: v for k, v in tree.items() if k != "dec_norm"}
    with pytest.raises(RuntimeError, match="Missing key"):
        convert.from_jax_params(cfg, cut)


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b"])
def test_init_params_draws_the_reference_distributions(arch):
    """Shapes and names equal the reference tree's; LayerNorm scales ones
    and biases zeros, dense biases zeros, dense weights normal with std
    1/sqrt(d_in), the embedding normal with std 0.02 (each std within 10%
    of the target over at least 2048 draws)."""
    from repro.models import model as jm
    import importlib
    ref = importlib.import_module(
        f"repro.configs.{arch.replace('-', '_')}").SMOKE
    want = {k: v.shape for k, v in _flatten(jax.tree.map(
        np.asarray, jm.init_params(ref, jax.random.PRNGKey(0)))).items()}
    cfg = load_arch(arch, smoke=True)
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    got = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        stacked = parts[0] in ("blocks", "enc_blocks", "dec_blocks")
        key = ".".join([parts[0]] + parts[2:]) if stacked else name
        got.setdefault(key, []).append(t)
    assert sorted(got) == sorted(want)
    for key, ts in got.items():
        shape = (len(ts), *ts[0].shape) if len(want[key]) > ts[0].dim() \
            else tuple(ts[0].shape)
        assert tuple(want[key]) == shape, key
        t = torch.stack(ts)
        if key.endswith(".bias") or key.endswith(".b"):
            assert torch.equal(t, torch.zeros_like(t)), key
        elif key.endswith(".scale"):
            assert torch.equal(t, torch.ones_like(t)), key
        elif key.endswith(".w"):
            target = 1 / math.sqrt(ts[0].shape[0])
            assert abs(float(t.std()) / target - 1) < 0.1, key
            assert abs(float(t.mean())) < 0.1 * target, key
        elif key.endswith(".embedding"):
            assert abs(float(t.std()) / 0.02 - 1) < 0.1, key


# ------------------------------------------------------------------ engine --
@functools.lru_cache(maxsize=None)
def _engines(impl):
    from repro.serve.engine import Engine, ServeConfig
    params, _, model = _weights()
    jcfg, pcfg = _configs(impl)
    max_len = PROMPT + NEW + 1
    jeng = Engine(jcfg, params, ServeConfig(batch=BATCH, max_len=max_len,
                                            warmup=False,
                                            kernel_plan="direct"))
    peng = port_engine.Engine(pcfg, model, port_engine.ServeConfig(
        batch=BATCH, max_len=max_len), device="cpu")
    return jeng, peng


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_matches_reference_engine(impl):
    jeng, peng = _engines(impl)
    jenc, penc = _encoded(impl)
    prompts = _tokens(3, (BATCH, PROMPT))
    want, wlog = jeng.generate(jnp.asarray(prompts), NEW, enc_out=jenc,
                               return_logits=True)
    before = _launches()
    got, glog = peng.generate(torch.from_numpy(prompts), NEW, enc_out=penc,
                              return_logits=True)
    assert _launches() == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(glog.numpy(), np.asarray(wlog), **LOGIT_TOL)
    # the encoder output is read: other frames give other logits
    _, other = peng.generate(torch.from_numpy(prompts), NEW,
                             enc_out=torch.flip(penc, dims=[0]),
                             return_logits=True)
    assert float((other - glog).abs().max()) > 1e-3


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_chunk_with_enc_out_matches_reference_engine(impl):
    jeng, peng = _engines(impl)
    jenc, penc = _encoded(impl)
    toks = _tokens(4, (BATCH, PROMPT))
    jcache = jeng._cache_factory(BATCH)
    pcache = port_model.init_cache(peng.cfg, BATCH, peng.scfg.max_len,
                                   torch.float32, "cpu")
    lo = 0
    for n in (5, 1, 2):
        chunk = toks[:, lo:lo + n]
        jcache, jlast = jeng.prefill_chunk(jcache, jnp.asarray(chunk), jenc)
        pcache, plast = peng.prefill_chunk(pcache, torch.from_numpy(chunk),
                                           penc)
        lo += n
        np.testing.assert_allclose(plast.numpy(), np.asarray(jlast),
                                   err_msg=f"chunk ending at {lo}",
                                   **LOGIT_TOL)
    _, whole = peng.prefill(torch.from_numpy(toks), penc)
    np.testing.assert_allclose(plast.numpy(), whole.numpy(), **LOGIT_TOL)


# --------------------------------------------------------------- scheduler --
def test_encdec_family_rejected_by_continuous_batching(capsys):
    """The reference's ``test_encdec_family_rejected``: the scheduler and
    the per-slot cache refuse the family up front, and so does the
    launcher's stream mode."""
    from repro_torch.launch import serve
    from repro_torch.serve import scheduler as port_sched
    cfg = load_arch("whisper-base", smoke=True)
    shell = object.__new__(port_engine.Engine)
    shell.cfg, shell.scfg = cfg, port_engine.ServeConfig(batch=2,
                                                         max_len=16)
    with pytest.raises(ValueError, match="encdec"):
        port_sched.Scheduler(shell)
    with pytest.raises(ValueError, match="encdec"):
        port_model.init_cache(cfg, 2, 16, torch.float32, per_slot_pos=True)
    _, peng = _engines("xla_chunked")
    with pytest.raises(ValueError, match="encdec"):
        peng.serve_stream(port_sched.synthetic_workload(
            2, seed=0, prompt_lens=(4,), new_tokens=(2,), vocab=256))
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                    "--arrival-rate", "0.5"])
    assert exc.value.code == 2
    assert "encdec archs are not supported by the scheduler" in \
        capsys.readouterr().err


@pytest.mark.parametrize("impl", IMPLS)
def test_serve_cli_runs_whisper_on_cpu(impl, capsys):
    from repro_torch.launch import serve
    before = _launches()
    out = serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                      "--attention-impl", impl, "--batch", "2",
                      "--prompt-len", "8", "--new", "4"])
    assert tuple(out.shape) == (2, 4)
    assert _launches() == before
    text = capsys.readouterr().out
    assert (f"[serve] whisper-smoke on cpu (encoder and decoder "
            f"self-attention {impl}, cross-attention xla_chunked)") in text
    assert "[serve] first sequence:" in text
