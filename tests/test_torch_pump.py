"""The pump on the port's attention and SSD ops, and their carry regions at
the ``hopper`` tier, on the CPU.

- ``ops.flash_attention``, ``ops.decode_attention``, ``ops.ssd_scan`` and
  ``ops.ssd_decode`` take every pump form the reference takes (an int, a
  ``PumpSpec``, ``(factor, mode)``, ``'auto'``, ``'measure'``); at each the
  port's values equal its pump-1 values exactly (the pump never changes a
  value; on CPU tensors the plain versions run) and the JAX package's at
  the same pump within 5e-6 (2e-5 rtol on the scan's state), the JAX
  package run as its own tests run it on the CPU (the compiler route,
  Pallas in interpret mode);
- ``'auto'`` picks the factor worked by hand from the Hopper constants;
- the built sets (``built`` of each kernel module) are plain functions of
  factor, mode and shape: a factor outside them is rejected;
- ``compile(backend='hopper')`` puts the regions of ``_flash_graph``,
  ``_decode_attention_graph`` and ``_ssd_graph`` at the ``hopper`` tier at
  M 1 / 2 / 4 x T / R wherever the kernel is built for the case (else at
  ``carryloop``, with the reason), and the result equals the port's numpy
  executor.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch import compiler  # noqa: E402
from repro_torch.core import executor  # noqa: E402
from repro_torch.core.autopump import BUILDERS  # noqa: E402
from repro_torch.core.ir import PumpSpec  # noqa: E402
from repro_torch.core.pump_plan import SMEM_BYTES, best_pump_factor  # noqa: E402
from repro_torch.kernels import decode_attention as port_da  # noqa: E402
from repro_torch.kernels import flash_attention as port_fa  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.kernels import ssd_decode as port_sd  # noqa: E402
from repro_torch.kernels import ssd_scan as port_ss  # noqa: E402

TOL = dict(rtol=5e-6, atol=5e-6)
STATE_TOL = dict(rtol=2e-5, atol=5e-6)
PUMPS = [1, 2, (2, "R"), PumpSpec(4, "T"), (4, "R"), "auto", "measure"]
IDS = ["1", "2", "R2", "T4-spec", "R4", "auto", "measure"]


@pytest.fixture(autouse=True)
def _private_compile_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    compiler.clear_memo()


def _jax_pump(pump):
    """The same pump request in the reference's own terms."""
    from repro.core.ir import PumpSpec as JPumpSpec
    if isinstance(pump, tuple):
        return JPumpSpec(factor=pump[0], mode=pump[1])
    if isinstance(pump, PumpSpec):
        return JPumpSpec(factor=pump.factor, mode=pump.mode)
    return pump


def _rng(seed):
    return np.random.default_rng(seed)


def _launches():
    return (port_fa.launches, port_da.launches, port_ss.launches,
            port_sd.launches)


# ------------------------------------------------------------ the ops --
@pytest.mark.parametrize("pump", PUMPS, ids=IDS)
def test_flash_pump_forms_match_reference(pump):
    from repro.kernels import ops as jax_ops
    rng = _rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 4, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = _launches()
    got = port_ops.flash_attention(tq, tk, tv, causal=True, bq=8, bkv=8,
                                   pump=pump)
    assert _launches() == before           # CPU tensors: the plain version
    base = port_ops.flash_attention(tq, tk, tv, causal=True)
    assert torch.equal(got, base)
    want = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, bq=8, bkv=8,
                                   pump=_jax_pump(pump))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pump", PUMPS, ids=IDS)
def test_decode_pump_forms_match_reference(pump):
    from repro.kernels import ops as jax_ops
    rng = _rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, 16), (2, 2, 32, 16), (2, 2, 32, 16)))
    pos = np.array([31, 9], np.int32)
    args = [torch.from_numpy(a) for a in (q, k, v, pos)]
    before = _launches()
    got = port_ops.decode_attention(*args, bkv=8, pump=pump)
    assert _launches() == before
    assert torch.equal(got, port_ops.decode_attention(*args))
    want = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos), bkv=8,
                                    pump=_jax_pump(pump))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _scan_inputs(seed, b, l, h, g, n, p):
    rng = _rng(seed)
    f32 = np.float32
    return (rng.standard_normal((b, l, h, p)).astype(f32),
            rng.uniform(0.25, 1.0, (b, l, h)).astype(f32),
            -rng.uniform(0.25, 1.0, (h,)).astype(f32),
            rng.standard_normal((b, l, g, n)).astype(f32),
            rng.standard_normal((b, l, g, n)).astype(f32))


@pytest.mark.parametrize("pump", PUMPS, ids=IDS)
def test_ssd_scan_pump_forms_match_reference(pump):
    from repro.kernels import ops as jax_ops
    arrays = _scan_inputs(2, 1, 32, 4, 2, 8, 8)
    targs = [torch.from_numpy(a) for a in arrays]
    before = _launches()
    y, st = port_ops.ssd_scan(*targs, chunk=8, final_state=True, pump=pump)
    assert _launches() == before
    y1, st1 = port_ops.ssd_scan(*targs, chunk=8, final_state=True)
    assert torch.equal(y, y1) and torch.equal(st, st1)
    y_want, st_want = jax_ops.ssd_scan(*map(jnp.asarray, arrays), chunk=8,
                                       final_state=True,
                                       pump=_jax_pump(pump))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_want), **STATE_TOL)


@pytest.mark.parametrize("pump", PUMPS, ids=IDS)
def test_ssd_decode_pump_forms_match_reference(pump):
    from repro.kernels import ops as jax_ops
    x, dt, a, bm, cm = _scan_inputs(3, 2, 1, 4, 2, 8, 8)
    state = _rng(4).standard_normal((2, 4, 8, 8)).astype(np.float32)
    arrays = (state, x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0])
    targs = [torch.from_numpy(np.ascontiguousarray(a_)) for a_ in arrays]
    before = _launches()
    y, st = port_ops.ssd_decode(*targs, pump=pump)
    assert _launches() == before
    y1, st1 = port_ops.ssd_decode(*targs)
    assert torch.equal(y, y1) and torch.equal(st, st1)
    y_want, st_want = jax_ops.ssd_decode(*map(jnp.asarray, arrays),
                                         pump=_jax_pump(pump))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_want), **TOL)


# -------------------------------------------------------- 'auto' by hand --
def test_auto_factors_by_hand():
    """The capacity model at the serving shapes, with the reference's
    blocks.  qwen3's flash (bq = bkv = 128, D 128, bf16): a block moves
    2·128·128·2 = 64 KiB, and 2·M·64 KiB fits 227 KiB only for M = 1.  The
    mamba2 scan (chunk 64, P 64, N 128): 64·(64 + 1 + 256)·4 + 64·64·4 =
    96.25 KiB staged, M = 1 again.  qwen3's decode step from its builder's
    estimate (bkv 128, D 128, fp32): 128 KiB, M = 1.  A small flash block
    (bq = bkv = 16, D 16, fp32: 2 KiB) is overhead-bound, so the largest
    built factor wins: 4."""
    bf16 = torch.bfloat16
    q = torch.zeros(8, 16, 512, 128, dtype=bf16)
    k = torch.zeros(8, 8, 512, 128, dtype=bf16)
    spec = port_ops._as_spec(
        "auto", q, block_bytes_in=2 * 128 * 128 * 2, block_bytes_out=0,
        flops_per_block=4.0 * 128 ** 3, max_factor=4)
    assert spec.factor == 1 and 2 * 2 * 65536 > SMEM_BYTES
    assert port_ops._max_built(lambda f: port_fa.built(f, "T", 128, bf16)) \
        == 4
    assert port_ops._max_built(lambda f: port_fa.built(
        f, "T", 128, torch.float32)) == 2
    assert port_ops._max_built(lambda f: port_ss.built(f, "T")) == 2
    scan = port_ops._as_spec(
        "auto", q, block_bytes_in=64 * (64 + 1 + 256) * 4,
        block_bytes_out=64 * 64 * 4, flops_per_block=2.0 * 64 * 64 * 192,
        max_factor=2)
    assert scan.factor == 1 and 2 * 2 * 98560 > SMEM_BYTES
    _g, est = BUILDERS["decode_attention"](8, 16, 512, 128, bkv=128,
                                           itemsize=4, hkv=8)
    assert est.block_bytes_in == 131072 and best_pump_factor(est) == 1
    small = port_ops._as_spec("auto", q, block_bytes_in=2 * 16 * 16 * 4,
                              block_bytes_out=0,
                              flops_per_block=4.0 * 16 ** 3, max_factor=4)
    assert small.factor == 4
    # and the ops run what they plan: CPU tensors, the plain version
    out = port_ops.flash_attention(q[:1, :2, :16].float(),
                                   k[:1, :1, :16].float(), k[:1, :1, :16]
                                   .float(), causal=True, pump="auto")
    assert out.shape == (1, 2, 16, 128)


# Inputs at which a kernel is built for no pump at all: flash at D 256 and
# D 6 and in fp16; decode at 64 q heads per kv head (64 lane slots at D
# 128), at D 6 and D 256, and with an fp16 cache.
UNBUILT = {
    "flash D256": ("flash", 256, torch.float32, 1),
    "flash D6": ("flash", 6, torch.float32, 1),
    "flash fp16": ("flash", 16, torch.float16, 1),
    "decode G64": ("decode", 128, torch.float32, 64),
    "decode D6": ("decode", 6, torch.float32, 1),
    "decode D256": ("decode", 256, torch.float32, 1),
    "decode fp16 cache": ("decode", 16, torch.float16, 1),
}


@pytest.mark.parametrize("pump", ["auto", "measure"])
@pytest.mark.parametrize("case", sorted(UNBUILT))
def test_planned_pump_where_nothing_is_built(case, pump):
    """'auto' and 'measure' plan with max_factor 1 where the kernel is
    built for no factor, so a CPU tensor runs the plain version exactly as
    with pump=1 (no ValueError from an empty max())."""
    op, d, dtype, group = UNBUILT[case]
    kernel = port_fa if op == "flash" else port_da
    assert not any(kernel.built(f, "T", d, dtype) if op == "flash"
                   else kernel.built(f, "T", group, d, dtype)
                   for f in (1, 2, 4))
    rng = np.random.default_rng(11)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)

    if op == "flash":
        q, k, v = t(1, 2, 9, d), t(1, 1, 9, d), t(1, 1, 9, d)
        got = port_ops.flash_attention(q, k, v, causal=True, pump=pump)
        want = port_ops.flash_attention(q, k, v, causal=True, pump=1)
    else:
        q, kc, vc = t(1, group, d), t(1, 1, 12, d), t(1, 1, 12, d)
        got = port_ops.decode_attention(q, kc, vc, 7, pump=pump)
        want = port_ops.decode_attention(q, kc, vc, 7, pump=1)
    assert got.dtype == dtype and torch.equal(got, want)


# ------------------------------------------------------------ built sets --
def test_built_sets_are_plain_functions():
    f32, bf16 = torch.float32, torch.bfloat16
    # flash: T4 at D 128 only in bf16 (66.5 KB fp32 tiles, 33.8 KB bf16)
    assert [c for c in port_fa.PUMPS if port_fa.built(*c, 128, f32)] == \
        [(1, "T"), (2, "T"), (2, "R"), (4, "R")]
    assert all(port_fa.built(*c, 128, bf16) for c in port_fa.PUMPS)
    assert all(port_fa.built(*c, 64, f32) for c in port_fa.PUMPS)
    assert port_fa.smem_bytes(4, "T", 128, f32) > SMEM_BYTES \
        >= port_fa.smem_bytes(4, "T", 128, bf16)
    assert port_fa.padded_dim(8) == 16 and port_fa.padded_dim(36) == 64
    # decode: a ring of two transactions; qwen3's fp32 cache takes T1, R2,
    # R4 (two 2-tile transactions are 256 KB); R needs D % 4M == 0
    assert [c for c in port_da.PUMPS if port_da.built(*c, 2, 128, f32)] == \
        [(1, "T"), (2, "R"), (4, "R")]
    assert port_da.smem_bytes(2, "T", 2, 128, f32) > SMEM_BYTES \
        >= port_da.smem_bytes(2, "T", 2, 128, bf16)
    assert port_da.built(2, "T", 2, 128, bf16)
    assert not port_da.built(4, "T", 2, 128, bf16)
    assert port_da.built(4, "T", 2, 64, bf16)
    # a lane holds at most 8 (head, chunk) slots: 8 heads of D 128
    assert port_da.built(1, "T", 8, 128, f32)
    assert not port_da.built(1, "T", 16, 128, f32)
    assert not port_da.built(4, "R", 2, 8, f32)
    assert port_da.built(2, "R", 2, 8, f32)
    # the scan: T4 does not fit
    assert [c for c in port_ss.PUMPS if port_ss.built(*c)] == \
        [(1, "T"), (2, "T"), (2, "R"), (4, "R")]
    # factors outside the sets
    for f, m in ((8, "T"), (3, "T"), (8, "R"), (16, "T")):
        assert not port_fa.built(f, m, 64, bf16)
        assert not port_da.built(f, m, 2, 64, bf16)
        assert not port_ss.built(f, m)
    assert port_fa.built(1, "R", 128, f32)       # R1 is T1
    assert not port_fa.built(1, "T", 130, f32)   # past the widest head dim
    assert not port_fa.built(1, "T", 6, f32)     # not a multiple of 4


def test_cuda_wrappers_check_the_built_set_after_the_device():
    """A CPU tensor never reaches a kernel: the wrappers refuse it before
    they look at the pump, and the ops never pass it on."""
    q = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        port_fa.flash_attention_cuda(q, q, q, pump=(8, "T"))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        port_ss.ssd_scan_cuda(torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2),
                              torch.zeros(2), torch.zeros(1, 8, 1, 4),
                              torch.zeros(1, 8, 1, 4), chunk=8, pump=4)


# ---------------------------------------------- the carry regions at hopper --
f32 = torch.float32
CARRY_CASES = {
    # label: (builder, args, kwargs, input shapes, outputs, built(M, mode))
    "flash": ("flash_attention", (1, 4, 32, 32, 32),
              dict(bq=8, bkv=8, hkv=2, causal=True, vector_width=8),
              {"q": (1, 4, 32, 32), "k": (1, 2, 32, 32),
               "v": (1, 2, 32, 32)}, ("o", "m", "l"),
              lambda m, mode: port_fa.built(m, mode, 32, f32)),
    "decode": ("decode_attention", (2, 4, 32, 32),
               dict(bkv=8, hkv=2, vector_width=4),
               {"q": (2, 4, 32), "k": (2, 2, 32, 32), "v": (2, 2, 32, 32),
                "pos": (2,)}, ("o",),
               lambda m, mode: port_da.built(m, mode, 2, 32, f32)),
    "ssd_scan": ("ssd_scan", (1, 32, 4, 8, 8),
                 dict(chunk=8, n_groups=2, final_state=True,
                      vector_width=8),
                 {"x": (1, 32, 4, 8), "dt": (1, 32, 4), "a": (4,),
                  "bmat": (1, 32, 2, 8), "cmat": (1, 32, 2, 8)},
                 ("y", "state"), port_ss.built),
}


def _carry_inputs(shapes):
    rng = _rng(5)
    data = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    if "pos" in data:
        data["pos"] = np.array([31, 12], np.int32)
    if "dt" in data:
        data["dt"] = np.abs(data["dt"]) * 0.5 + 0.25
        data["a"] = -(np.abs(data["a"]) * 0.5 + 0.25)
    return data


@pytest.mark.parametrize("mode", ["T", "R"])
@pytest.mark.parametrize("factor", [1, 2, 4])
@pytest.mark.parametrize("label", sorted(CARRY_CASES))
def test_carry_regions_at_hopper_match_executor(label, factor, mode):
    name, args, kw, shapes, outs, built = CARRY_CASES[label]
    g, _ = BUILDERS[name](*args, **kw)
    kern = compiler.compile(g, factor=factor, mode=mode, backend="hopper",
                            cache=False, memoize=False, device="cpu")
    (em,) = kern.report.emission.values()
    assert em["pump"] == factor and em["carry"]
    want_tier = "hopper" if built(factor, mode) else "carryloop"
    assert em["tier"] == want_tier, em["why"]
    if want_tier == "carryloop":
        assert "not built" in em["why"][-1]
    data = _carry_inputs(shapes)
    before = _launches()
    got = kern({k: torch.from_numpy(v) for k, v in data.items()})
    assert _launches() == before
    gold = executor.run(kern.graph, dict(data))
    for o in outs:
        np.testing.assert_allclose(got[o].numpy(), gold[o],
                                   err_msg=f"{label} M{factor} {mode} {o}",
                                   **STATE_TOL)


def test_carry_region_binds_the_op(monkeypatch):
    """The hopper tier of a carry region calls the op at the plan's (pump,
    mode), with the graph's own causal flag and scale."""
    calls = []
    real = port_ops.flash_attention

    def spy(*a, **kw):
        calls.append({k: kw[k] for k in ("causal", "scale", "pump",
                                         "stats")})
        return real(*a, **kw)

    monkeypatch.setattr(port_ops, "flash_attention", spy)
    name, args, kw, shapes, _outs, _b = CARRY_CASES["flash"]
    g, _ = BUILDERS[name](*args, **dict(kw, scale=0.25))
    kern = compiler.compile(g, factor=2, mode="R", backend="hopper",
                            cache=False, memoize=False, device="cpu")
    kern({k: torch.from_numpy(v) for k, v in _carry_inputs(shapes).items()})
    assert calls == [dict(causal=True, scale=0.25, pump=(2, "R"),
                          stats=True)]
