"""The port's SSM slice against the JAX package on the same numpy inputs.

The SSD ops' plain versions (``repro_torch.kernels.ref``) are held to the
reference's Pallas kernel (interpret mode), its compiled final-state
kernel and its plain-jnp references at 5e-6 on y and the decode state, and
2e-5 (rtol) on the scan's final state as ``tests/test_decode.py`` holds the
reference's own: the state sums 16+ steps of decayed products, so its
rounding grows with L.  mamba2 SMOKE runs on the reference's own
``init_params``, handed across through ``convert.from_jax_params``; its
logits are held to 1e-5 as the dense model's are
(``tests/test_torch_model.py``), and the greedy tokens of the two engines
must be identical.  Everything runs in fp32 on the CPU.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.configs import mamba2_1_3b as port_mamba2  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.kernels import ssd_decode as port_sd  # noqa: E402
from repro_torch.kernels import ssd_scan as port_ss  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import ssm as port_ssm  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402
from torch_config_parity import assert_config_mirrors  # noqa: E402

TOL = dict(rtol=5e-6, atol=5e-6)
STATE_TOL = dict(rtol=2e-5, atol=5e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, PROMPT, STEPS = 2, 8, 6


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))


def _scan_inputs(seed, b, l, h, g, n, p):
    """x, B, C normal; dt > 0 and A < 0, the recurrence's contract, in the
    range of ``tests/differential.py``'s SSD cases."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((b, l, h, p)).astype(f32),
            rng.uniform(0.25, 1.0, (b, l, h)).astype(f32),
            -rng.uniform(0.25, 1.0, (h,)).astype(f32),
            rng.standard_normal((b, l, g, n)).astype(f32),
            rng.standard_normal((b, l, g, n)).astype(f32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _launch_counts():
    return port_ss.launches, port_sd.launches


def test_config_mirrors_reference():
    from repro.configs import mamba2_1_3b as jax_mamba2
    for name in ("CONFIG", "SMOKE"):
        ref, port = getattr(jax_mamba2, name), getattr(port_mamba2, name)
        assert (port.kernel_plan, ref.kernel_plan) == ("direct", "measure")
        # kernel_plan: the port's default, 'direct'; SSMConfig field by
        # field
        assert_config_mirrors(port, ref, name)
    assert port_mamba2.SMOKE.activation_dtype == torch.float32
    assert port_mamba2.CONFIG.activation_dtype == torch.bfloat16


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_scan_matches_pallas_kernel(g, chunk):
    from repro.kernels.ssd_scan import ssd_scan_pallas
    x, dt, a, bm, cm = _scan_inputs(0, 2, 32, 4, g, 16, 8)
    before = _launch_counts()
    got = port_ops.ssd_scan(*_torch(x, dt, a, bm, cm), chunk=chunk)
    assert _launch_counts() == before      # CPU tensors take the plain path
    want = ssd_scan_pallas(*_jax(x, dt, a, bm, cm), chunk=chunk,
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_final_state_matches_compiled_kernel(g):
    from repro.kernels import ops as jax_ops
    x, dt, a, bm, cm = _scan_inputs(1, 2, 32, 4, g, 16, 8)
    y, st = port_ops.ssd_scan(*_torch(x, dt, a, bm, cm), chunk=8,
                              final_state=True)
    y_want, st_want = jax_ops.ssd_scan(*_jax(x, dt, a, bm, cm), chunk=8,
                                       final_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_want), **STATE_TOL)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("l,chunk", [(30, 8), (5, 16), (37, 16)])
def test_ssd_scan_ragged_matches_sequential_reference(g, l, chunk):
    """A ragged L is padded with dt = 0 steps; the sequential recurrence
    has no chunks at all, so it shows the padding is exact."""
    from repro.compiler.registry import _ssd_scan_reference
    x, dt, a, bm, cm = _scan_inputs(2, 2, l, 4, g, 16, 8)
    y, st = port_ref.ssd_scan(*_torch(x, dt, a, bm, cm), chunk=chunk,
                              final_state=True)
    y_want, st_want = _ssd_scan_reference(*_jax(x, dt, a, bm, cm))
    assert y.shape == (2, l, 4, 8) and st.shape == (2, 4, 16, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_want), **STATE_TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_matches_references(g):
    from repro.compiler.registry import _ssd_decode_reference
    from repro.kernels import ops as jax_ops
    x, dt, a, bm, cm = _scan_inputs(3, 3, 1, 4, g, 16, 8)
    state = np.random.default_rng(4).standard_normal((3, 4, 16, 8)) \
        .astype(np.float32)
    args = (state, x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0])
    before = _launch_counts()
    y, st = port_ops.ssd_decode(*_torch(*args))
    assert _launch_counts() == before
    assert y.dtype == st.dtype == torch.float32
    for name, fn in (("jnp reference", _ssd_decode_reference),
                     ("compiled kernel", jax_ops.ssd_decode)):
        y_want, st_want = fn(*_jax(*args))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_want),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_reference_xla_route(g):
    from repro.models import ssm as jax_ssm
    x, dt, a, bm, cm = _scan_inputs(5, 2, 32, 4, g, 16, 8)
    y, st = port_ssm._ssd_chunked(*_torch(x, dt, a, bm, cm), 8)
    y_want, st_want = jax_ssm._ssd_xla(*_jax(x, dt, a, bm, cm), 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_want), **STATE_TOL)
    # in fp32 the port's two routes compute the same function
    y_k, st_k = port_ref.ssd_scan(*_torch(x, dt, a, bm, cm), chunk=8,
                                  final_state=True)
    np.testing.assert_allclose(y.numpy(), y_k.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), st_k.numpy(), **STATE_TOL)


# ----------------------------------------------------------- mamba2 SMOKE --
@pytest.fixture(scope="module")
def weights():
    from repro.configs import mamba2_1_3b as jax_mamba2
    from repro.models import transformer as jax_tf
    params = jax_tf.init_params(jax_mamba2.SMOKE, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return params, convert.from_jax_params(port_mamba2.SMOKE, tree)


def _configs(impl):
    from repro.configs import mamba2_1_3b as jax_mamba2
    # the reference's kernel route on its direct (registry-free) plans
    jcfg = dataclasses.replace(jax_mamba2.SMOKE, ssm_impl=impl,
                               kernel_plan="direct")
    pcfg = dataclasses.replace(port_mamba2.SMOKE, ssm_impl=impl)
    return jcfg, pcfg


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, port_mamba2.SMOKE.vocab_size, shape, dtype=np.int32)


def test_from_jax_params_loads_every_leaf(weights):
    params, model = weights
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    for leaf in ("conv_w", "A_log", "dt_bias", "D"):
        np.testing.assert_array_equal(
            getattr(model.blocks[1].mixer, leaf).numpy(),
            np.asarray(params["blocks"]["mixer"][leaf][1]))
    np.testing.assert_array_equal(
        model.blocks[0].mixer.in_proj.w.numpy(),
        np.asarray(params["blocks"]["mixer"]["in_proj"]["w"][0]))


def test_init_params_distributions():
    cfg = port_mamba2.SMOKE
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    for block in model.blocks:
        mix = block.mixer
        torch.testing.assert_close(
            mix.A_log, torch.log(torch.linspace(1.0, 16.0, h)))
        assert torch.equal(mix.D, torch.ones(h))
        assert torch.equal(mix.dt_bias, torch.zeros(h))
        assert torch.equal(mix.conv_b, torch.zeros_like(mix.conv_b))
        assert abs(mix.conv_w.std().item() - 0.1) < 0.02
        assert abs(mix.conv_w.mean().item()) < 0.02
        w = mix.in_proj.w
        assert abs(w.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.1
        assert torch.equal(block.norm.scale, torch.ones(cfg.d_model))
        assert torch.equal(mix.norm.scale, torch.ones(d_in))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("seq", [16, 12])
def test_forward_logits_match(weights, impl, seq):
    """seq 12 is ragged for chunk 8: the plain route falls back to chunk 1,
    the kernel route masks the last chunk."""
    from repro.models import transformer as jax_tf
    params, model = weights
    jcfg, pcfg = _configs(impl)
    toks = _tokens(0, (BATCH, seq))
    want, _ = jax_tf.forward(jcfg, params, jnp.asarray(toks))
    got, _ = port_model.forward(pcfg, model,
                                {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_cached_prefill_and_decode_match(weights, impl):
    from repro.models import transformer as jax_tf
    params, model = weights
    jcfg, pcfg = _configs(impl)
    toks = _tokens(1, (BATCH, PROMPT + STEPS))
    jstep = jax.jit(functools.partial(jax_tf.decode_step, jcfg))
    jcache = jax_tf.init_cache(jcfg, BATCH, 4, jnp.float32)
    pcache = port_model.init_cache(pcfg, BATCH, 4, torch.float32)
    want, jcache = jstep(params, jnp.asarray(toks[:, :PROMPT]), jcache)
    got, pcache = port_model.decode_step(
        pcfg, model, {"tokens": torch.from_numpy(toks[:, :PROMPT]).long()},
        pcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for i, layer in enumerate(pcache["blocks"]):
        np.testing.assert_allclose(
            layer["state"].numpy(), np.asarray(jcache["blocks"]["state"][i]),
            **STATE_TOL)
        np.testing.assert_allclose(
            layer["conv"].numpy(), np.asarray(jcache["blocks"]["conv"][i]),
            **TOL)
    for i in range(PROMPT, PROMPT + STEPS):
        want, jcache = jstep(params, jnp.asarray(toks[:, i:i + 1]), jcache)
        got, pcache = port_model.decode_step(
            pcfg, model, {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()},
            pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"decode step at pos {i}",
                                   **LOGIT_TOL)
    assert pcache["blocks"][0]["pos"] == PROMPT + STEPS
    assert pcache["blocks"][0]["state"].dtype == torch.float32
    np.testing.assert_allclose(
        pcache["blocks"][1]["state"].numpy(),
        np.asarray(jcache["blocks"]["state"][1]), **STATE_TOL)


def test_cache_holds_no_max_len():
    a = port_model.init_cache(port_mamba2.SMOKE, 2, 8, torch.float32)
    b = port_model.init_cache(port_mamba2.SMOKE, 2, 4096, torch.float32)
    for la, lb in zip(a["blocks"], b["blocks"]):
        assert la["state"].shape == lb["state"].shape == (2, 4, 16, 32)
        assert la["conv"].shape == lb["conv"].shape == (2, 3, 160)
        assert la["pos"] == 0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_continuation_prefill_and_per_slot_decode_match(weights, impl):
    """A prompt in continuation chunks (``prefill_continuation``; the 2 and
    1 are shorter than the conv window), then decode steps on a per-slot
    cache at ragged positions: logits and the state / conv leaves against
    the reference's jitted ``decode_step`` on the same configs."""
    from repro.models import transformer as jax_tf
    params, model = weights
    jcfg, pcfg = (dataclasses.replace(c, prefill_continuation=True)
                  for c in _configs(impl))
    toks = _tokens(4, (BATCH, 12))
    jstep = jax.jit(functools.partial(jax_tf.decode_step, jcfg))
    jcache = jax_tf.init_cache(jcfg, BATCH, 4, jnp.float32)
    pcache = port_model.init_cache(pcfg, BATCH, 4, torch.float32)
    lo = 0
    for n in (5, 2, 1, 4):
        want, jcache = jstep(params, jnp.asarray(toks[:, lo:lo + n]), jcache)
        got, pcache = port_model.decode_step(
            pcfg, model, {"tokens": torch.from_numpy(toks[:, lo:lo + n])},
            pcache)
        lo += n
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"chunk ending at {lo}",
                                   **LOGIT_TOL)
    for i, layer in enumerate(pcache["blocks"]):
        np.testing.assert_allclose(layer["state"].numpy(), np.asarray(
            jcache["blocks"]["state"][i]), **STATE_TOL)
        np.testing.assert_allclose(layer["conv"].numpy(), np.asarray(
            jcache["blocks"]["conv"][i]), **TOL)
        assert layer["pos"] == 12
    # per-slot: the same state, rows at their own (bookkeeping) depths
    jslot = jax_tf.init_cache(jcfg, BATCH, 4, jnp.float32, per_slot_pos=True)
    pslot = port_model.init_cache(pcfg, BATCH, 4, torch.float32,
                                  per_slot_pos=True)
    jslot = jax.tree.map(lambda a, b: b if b.shape == a.shape else a,
                         jslot, jcache)
    jslot["blocks"]["pos"] = jnp.asarray([[12, 3]] * pcfg.n_layers,
                                         jnp.int32)
    for big, small in zip(pslot["blocks"], pcache["blocks"]):
        big["state"].copy_(small["state"])
        big["conv"].copy_(small["conv"])
        big["pos"].copy_(torch.tensor([12, 3]))
    for step in range(3):
        t = _tokens(20 + step, (BATCH, 1))
        want, jslot = jstep(params, jnp.asarray(t), jslot)
        got, pslot = port_model.decode_step(
            pcfg, model, {"tokens": torch.from_numpy(t)}, pslot)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"per-slot step {step}",
                                   **LOGIT_TOL)
    assert pslot["blocks"][0]["pos"].tolist() == [15, 6]
    np.testing.assert_allclose(pslot["blocks"][1]["state"].numpy(),
                               np.asarray(jslot["blocks"]["state"][1]),
                               **STATE_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_greedy_tokens_match_reference_engine(weights, impl):
    from repro.serve.engine import Engine, ServeConfig
    params, model = weights
    jcfg, pcfg = _configs(impl)
    prompts = _tokens(2, (BATCH, PROMPT))
    want = Engine(jcfg, params, ServeConfig(batch=BATCH, max_len=32,
                                            warmup=False,
                                            kernel_plan="direct")
                  ).generate(jnp.asarray(prompts), STEPS)
    eng = port_engine.Engine(pcfg, model,
                             port_engine.ServeConfig(batch=BATCH, max_len=32),
                             device="cpu")
    before = _launch_counts()
    got = eng.generate(torch.from_numpy(prompts).long(), STEPS)
    assert _launch_counts() == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("call", ["scan", "decode"])
def test_cuda_wrappers_reject_cpu_tensors(call):
    x, dt, a, bm, cm = _torch(*_scan_inputs(6, 1, 8, 4, 1, 16, 8))
    before = _launch_counts()
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        if call == "scan":
            port_ss.ssd_scan_cuda(x, dt, a, bm, cm, chunk=8)
        else:
            port_sd.ssd_decode_cuda(torch.zeros(1, 4, 16, 8), x[:, 0],
                                    dt[:, 0], a, bm[:, 0], cm[:, 0])
    assert _launch_counts() == before


def test_serve_cli_runs_ssm_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                      "--ssm-impl", "pallas", "--batch", "2",
                      "--prompt-len", "9", "--new", "4"])
    assert tuple(out.shape) == (2, 4)
    assert "mamba2-smoke on cpu (pallas)" in capsys.readouterr().out
