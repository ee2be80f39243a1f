"""The port's MoE slice (deepseek-v2-lite: MLA + routed experts) against the
JAX package on the same numpy inputs.

The grouped GEMM's plain versions (``repro_torch.kernels.ref``) are held
exactly to the reference's Pallas kernel in interpret mode and to its
compiled ragged reduce form on integer-valued inputs, where every partial
sum is an exact fp32 integer, so no summation order can show.  MLA is held
to the reference at 5e-6 (the attention ops' tolerance,
``tests/test_torch_kernels.py``); ``moe_apply`` on each of its three routes
and the SMOKE logits at 1e-5, as the dense and SSM models are
(``tests/test_torch_model.py``): XLA and torch order their fp32 sums
differently, which shows as a few 1e-6 after two layers.  The model runs
on the reference's own ``init_params``, handed across through
``convert.from_jax_params``; the greedy tokens of the engines must be
identical.  Everything runs in fp32 on the CPU, where the ops take their
plain versions.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.configs import deepseek_v2_lite_16b as port_ds  # noqa: E402
from repro_torch.core.ir import PumpSpec  # noqa: E402
from repro_torch.kernels import grouped_gemm as port_gg  # noqa: E402
from repro_torch.kernels import ops as port_ops  # noqa: E402
from repro_torch.kernels import ref as port_ref  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402
from torch_config_parity import assert_config_mirrors  # noqa: E402

TOL = dict(rtol=5e-6, atol=5e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, PROMPT, STEPS = 2, 8, 6


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))


def _ints(seed, *shape):
    """Integer values in [-4, 4], as fp32."""
    return np.random.default_rng(seed).integers(-4, 5, shape) \
        .astype(np.float32)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _jcfg(**moe):
    from repro.configs import deepseek_v2_lite_16b as jax_ds
    cfg = jax_ds.SMOKE
    return dataclasses.replace(cfg, kernel_plan="direct",
                               moe=dataclasses.replace(cfg.moe, **moe))


def _pcfg(**moe):
    cfg = port_ds.SMOKE
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


RAGGED = dict(ragged_dropless=True, inference_capacity_factor=0.0)
DENSE = dict(ragged_dropless=False, inference_capacity_factor=0.0)


# ------------------------------------------------------------------ config --
def test_config_mirrors_reference():
    from repro.configs import deepseek_v2_lite_16b as jax_ds
    for name in ("CONFIG", "SMOKE"):
        ref, port = getattr(jax_ds, name), getattr(port_ds, name)
        assert (port.kernel_plan, ref.kernel_plan) == ("direct", "measure")
        # kernel_plan: the port's default, 'direct'; MoEConfig and
        # MLAConfig field by field
        assert_config_mirrors(port, ref, name)
    assert port_ds.CONFIG.activation_dtype == torch.bfloat16
    assert port_ds.SMOKE.activation_dtype == torch.float32


def test_load_arch_names_the_missing_families():
    """No family is missing any more: the MoE, hybrid, enc-dec and VLM
    configs all load."""
    from repro_torch.configs import internvl2_2b, whisper_base, zamba2_2_7b
    from repro_torch.configs.base import load_arch
    assert load_arch("deepseek-v2-lite-16b") is port_ds.CONFIG
    assert load_arch("zamba2-2.7b") is zamba2_2_7b.CONFIG
    assert load_arch("whisper-base") is whisper_base.CONFIG
    assert load_arch("internvl2-2b") is internvl2_2b.CONFIG
    assert load_arch("whisper-base", smoke=True) is whisper_base.SMOKE
    assert load_arch("internvl2-2b", smoke=True) is internvl2_2b.SMOKE


# ------------------------------------------------------- the grouped GEMM --
@pytest.mark.parametrize("e,c,d,f,blk,pump", [
    (3, 16, 32, 16, 8, PumpSpec(1)), (3, 16, 32, 16, 8, PumpSpec(2)),
    (2, 8, 64, 32, 8, PumpSpec(4)), (2, 16, 32, 16, 8, PumpSpec(2, "R")),
    (4, 8, 16, 8, 8, PumpSpec(1, "R"))])
def test_grouped_gemm_matches_pallas_kernel(e, c, d, f, blk, pump):
    from repro.kernels.grouped_gemm import grouped_gemm_pallas
    x, w = _ints(0, e, c, d), _ints(1, e, d, f)
    want = grouped_gemm_pallas(jnp.asarray(x), jnp.asarray(w), bc=blk,
                               bf=blk, bd=blk, pump=pump, interpret=True)
    got = port_ref.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    before = port_gg.launches
    via_ops = port_ops.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                                    pump=pump)
    assert port_gg.launches == before     # CPU tensors take the plain path
    np.testing.assert_array_equal(via_ops.numpy(), np.asarray(want))


@pytest.mark.parametrize("sizes,pump", [
    ([5, 0, 12, 3], 1), ([5, 0, 12, 3], PumpSpec(2, "R")),
    ([1, 1, 0, 30], 2), ([0, 0, 0, 16], 1)])
def test_ragged_grouped_gemm_matches_compiled_reduce_form(sizes, pump):
    """The reference compiles the single-output reduce form over the ragged
    ``_grouped_gemm_graph`` (group-indexed tables)."""
    from repro.core.ir import PumpSpec as JaxPumpSpec
    from repro.kernels import ops as jax_ops
    e, d, f = len(sizes), 16, 8
    x, w = _ints(2, sum(sizes), d), _ints(3, e, d, f)
    jpump = JaxPumpSpec(pump.factor, pump.mode) \
        if isinstance(pump, PumpSpec) else pump
    want = jax_ops.grouped_gemm(jnp.asarray(x), jnp.asarray(w), bc=8, bf=8,
                                bd=8, pump=jpump, group_sizes=sizes)
    got = port_ops.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                                bc=8, bf=8, bd=8, pump=pump,
                                group_sizes=sizes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    per_expert, off = [], 0
    for ei, sz in enumerate(sizes):
        per_expert.append(x[off:off + sz] @ w[ei])
        off += sz
    np.testing.assert_array_equal(got.numpy(), np.concatenate(per_expert))


@pytest.mark.parametrize("bc", [4, 16])
def test_tile_table_covers_groups_and_surplus(bc):
    sizes = torch.tensor([5, 0, 12, 3])
    n_tiles = sum(-(-int(s) // bc) for s in sizes) + 3
    tiles = port_gg.tile_table(sizes, bc, n_tiles)
    assert tiles.dtype == torch.int32 and tiles.shape == (n_tiles, 3)
    covered = []
    for ex, first, count in tiles.tolist():
        assert 0 < count <= bc
        covered += [(r, ex) for r in range(first, first + count)]
    rows = [r for r, _ in covered]
    assert rows == list(range(len(rows)))              # end to end, in order
    groups = [ex for _, ex in covered if ex >= 0]
    assert groups == [0] * 5 + [2] * 12 + [3] * 3
    assert all(ex == -1 for _, ex in covered[20:])     # surplus tiles
    # a buffer the worst-case table covers: surplus rows come out zero
    x, w = torch.from_numpy(_normal(4, len(rows), 8)), \
        torch.from_numpy(_normal(5, 4, 8, 6))
    out = port_ref.ragged_grouped_gemm(x, w, tiles)
    assert torch.equal(out[20:], torch.zeros_like(out[20:]))
    torch.testing.assert_close(out[5:17], x[5:17] @ w[2])


def test_moe_ragged_layout_matches_reference_rows():
    """The device-built layout puts every assignment where the reference's
    host tables do (``repro/models/moe.py:70-98``)."""
    rng = np.random.default_rng(6)
    t, k, e = 37, 2, 8
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    rows, padded, tiles, n_rows = port_moe.ragged_layout(
        torch.from_numpy(idx), e)
    flat_e = idx.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    counts = np.bincount(flat_e, minlength=e)
    want_padded = [-(-int(c) // 16) * 16 if c else 0 for c in counts]
    offs = np.concatenate(([0], np.cumsum(want_padded)[:-1]))
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    want_rows = np.empty(t * k, np.int64)
    want_rows[order] = offs[flat_e[order]] + (np.arange(t * k)
                                              - starts[flat_e[order]])
    np.testing.assert_array_equal(padded.numpy(), want_padded)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    assert n_rows == (-(-t * k // 16) + e) * 16 == tiles.shape[0] * 16


@pytest.mark.parametrize("case", ["rows", "experts", "mode_r", "both"])
def test_grouped_gemm_keeps_reference_value_errors(case):
    from repro.kernels import ops as jax_ops
    x, w = _ints(7, 10, 16), _ints(8, 3, 16, 8)
    kwargs = {"rows": dict(group_sizes=[4, 4, 4]),
              "experts": dict(group_sizes=[5, 5]),
              "mode_r": dict(group_sizes=[4, 4, 2], bf=6,
                             pump=PumpSpec(4, "R")),
              "both": dict(group_sizes=[4, 4, 2])}[case]
    with pytest.raises(ValueError) as got:
        port_ops.grouped_gemm(torch.from_numpy(x), torch.from_numpy(w),
                              tiles=(torch.zeros((1, 3), dtype=torch.int32)
                                     if case == "both" else None),
                              **kwargs)
    if case == "both":                   # the port's own third form
        assert "not both" in str(got.value)
        return
    if case == "mode_r":                 # the hand-wired kernel's check
        from repro.kernels.grouped_gemm import grouped_gemm_pallas
        with pytest.raises(ValueError) as want:
            grouped_gemm_pallas(jnp.asarray(x)[None], jnp.asarray(w)[:1],
                                bc=2, bf=6, bd=4, pump=PumpSpec(4, "R"))
    else:
        with pytest.raises(ValueError) as want:
            jax_ops.grouped_gemm(jnp.asarray(x), jnp.asarray(w), **kwargs)
    assert str(got.value) == str(want.value)


def test_cuda_wrapper_rejects_cpu_tensors():
    x, w = torch.zeros(16, 8), torch.zeros(2, 8, 4)
    tiles = port_gg.tile_table(torch.tensor([16, 0]), 16, 1)
    before = port_gg.launches
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        port_gg.grouped_gemm_cuda(x, w, tiles)
    assert port_gg.launches == before


def test_transactions_match_reference():
    from repro.kernels import grouped_gemm as jax_gg
    for pump in (1, 2, PumpSpec(2, "R")):
        assert port_gg.transactions(4, 256, 512, 256, pump=pump) \
            == jax_gg.transactions(4, 256, 512, 256, pump=pump)


# --------------------------------------------------------- SMOKE weights --
@pytest.fixture(scope="module")
def weights():
    from repro.configs import deepseek_v2_lite_16b as jax_ds
    from repro.models import transformer as jax_tf
    params = jax_tf.init_params(jax_ds.SMOKE, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return params, convert.from_jax_params(port_ds.SMOKE, tree)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, port_ds.SMOKE.vocab_size, shape, dtype=np.int32)


def test_from_jax_params_loads_every_leaf(weights):
    params, model = weights
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    assert len(model.blocks_dense) == 1 and len(model.blocks) == 1
    np.testing.assert_array_equal(
        model.blocks_dense[0].mlp.up.w.numpy(),
        np.asarray(params["blocks_dense"]["mlp"]["up"]["w"][0]))
    np.testing.assert_array_equal(
        model.blocks_dense[0].attn.wkv_b.w.numpy(),
        np.asarray(params["blocks_dense"]["attn"]["wkv_b"]["w"][0]))
    for leaf in ("gate", "up", "down"):
        np.testing.assert_array_equal(
            getattr(model.blocks[0].moe, leaf).numpy(),
            np.asarray(params["blocks"]["moe"][leaf][0]))
    np.testing.assert_array_equal(
        model.blocks[0].moe.shared.down.w.numpy(),
        np.asarray(params["blocks"]["moe"]["shared"]["down"]["w"][0]))


def test_init_params_distributions():
    cfg = dataclasses.replace(port_ds.SMOKE, n_layers=5)
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    d, de = cfg.d_model, cfg.moe.d_expert
    for block in model.blocks:
        m = block.moe
        for w, fan_in in ((m.gate, d), (m.up, d), (m.down, de)):
            assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
            assert abs(w.mean().item()) * np.sqrt(fan_in) < 0.05
        assert abs(m.router.w.std().item() * np.sqrt(d) - 1.0) < 0.1
        assert torch.equal(block.attn.kv_norm.scale,
                           torch.ones(cfg.mla.kv_lora_rank))
    assert len(model.blocks_dense) == 1 and len(model.blocks) == 4


# ---------------------------------------------------------------- moe_apply --
def _moe_input(seed, b, s):
    return _normal(seed, b, s, port_ds.SMOKE.d_model)


@pytest.mark.parametrize("route,moe,dropless,s", [
    ("capacity", {}, False, 8),
    ("capacity-4096", {}, False, 2048),
    ("dense-dropless", DENSE, True, 8),
    ("capped-drops", dict(inference_capacity_factor=0.5), True, 16),
    ("ragged", RAGGED, True, 8),
    ("ragged-one-token", RAGGED, True, 1)])
def test_moe_apply_matches_reference(weights, route, moe, dropless, s):
    """Every route against the reference's eager ``moe_apply``; the ragged
    one reaches the reference's ragged path (concrete routing, 'direct'
    plan), which compiles the grouped GEMM's reduce form."""
    from repro.models import moe as jax_moe
    params, model = weights
    x = _moe_input(9, 2, s)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    want, want_aux = jax_moe.moe_apply(jp, _jcfg(**moe), jnp.asarray(x),
                                       dropless=dropless)
    got, aux = port_moe.moe_apply(model.blocks[0].moe, _pcfg(**moe),
                                  torch.from_numpy(x), dropless=dropless)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    if route == "capped-drops":
        # icf 0.5 caps each expert below its load here: tokens are dropped,
        # so the output differs from the dropless one
        full, _ = port_moe.moe_apply(model.blocks[0].moe, _pcfg(**DENSE),
                                     torch.from_numpy(x), dropless=True)
        assert not torch.allclose(full, got)


@pytest.mark.parametrize("s", [8, 1])
def test_moe_registry_ragged_route_matches(weights, s):
    """The ragged route under kernel_plan='measure': group sizes on the
    host, bucketed by the registry's policy, the three products through
    ``PlanRegistry.grouped_gemm`` (the compiled ragged graph), against the
    dense dropless path and the reference's registry route, at the file's
    tolerance; a fresh routing is planned at the registry's
    ``ragged_pump`` (1), never measured."""
    from repro.compiler import registry as jax_reg
    from repro.models import moe as jax_moe
    from repro_torch.compiler.registry import (PlanRegistry,
                                               set_default_registry)
    params, model = weights
    x = _moe_input(9, 2, s)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    reg = PlanRegistry(cache=False)
    old, jold = set_default_registry(reg), jax_reg.set_default_registry(
        jax_reg.PlanRegistry(cache=False))
    try:
        want, want_aux = jax_moe.moe_apply(
            jp, dataclasses.replace(_jcfg(**RAGGED), kernel_plan="measure"),
            jnp.asarray(x), dropless=True)
        got, aux = port_moe.moe_apply(
            model.blocks[0].moe,
            dataclasses.replace(_pcfg(**RAGGED), kernel_plan="measure"),
            torch.from_numpy(x), dropless=True)
    finally:
        set_default_registry(old)
        jax_reg.set_default_registry(jold)
    dense, _ = port_moe.moe_apply(model.blocks[0].moe, _pcfg(**DENSE),
                                  torch.from_numpy(x), dropless=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **LOGIT_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    plans = reg.plans()
    assert plans and all(pl["kernel"] == "grouped_gemm" and
                         pl["pump"] == 1 and not pl["measured"]
                         for pl in plans)
    assert reg.stats.measure_s == 0.0 and reg.stats.fallbacks == 0


# --------------------------------------------------------------------- MLA --
@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_prefill_decode_and_forward_match(q_lora):
    from repro.configs import deepseek_v2_lite_16b as jax_ds
    from repro.models import attention as jax_attn
    jcfg = dataclasses.replace(
        jax_ds.SMOKE, mla=dataclasses.replace(jax_ds.SMOKE.mla,
                                              q_lora_rank=q_lora))
    pcfg = dataclasses.replace(
        port_ds.SMOKE, mla=dataclasses.replace(port_ds.SMOKE.mla,
                                               q_lora_rank=q_lora))
    jp = jax_attn.mla_init(jax.random.PRNGKey(3), jcfg)
    mla = port_attn.MLA(pcfg)
    flat = convert._flatten(jax.tree.map(np.asarray, jp))
    mla.load_state_dict({k: torch.tensor(v) for k, v in flat.items()},
                        strict=True)
    mla.requires_grad_(False)
    x = _normal(10, BATCH, PROMPT + 3, pcfg.d_model)
    pos = np.arange(PROMPT + 3)
    want, _ = jax_attn.mla_apply(jp, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos))
    got, _ = port_attn.mla_apply(mla, pcfg, torch.from_numpy(x),
                                 positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jc = jax_attn.mla_cache_init(jcfg, BATCH, 16, jnp.float32)
    pc = port_attn.mla_cache_init(pcfg, BATCH, 16, torch.float32)
    want, jc = jax_attn.mla_apply(jp, jcfg, jnp.asarray(x[:, :PROMPT]),
                                  positions=jnp.asarray(pos[:PROMPT]),
                                  cache=jc)
    got, pc = port_attn.mla_apply(mla, pcfg, torch.from_numpy(x[:, :PROMPT]),
                                  positions=torch.from_numpy(pos[:PROMPT]),
                                  cache=pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(PROMPT, PROMPT + 3):
        want, jc = jax_attn.mla_apply(jp, jcfg, jnp.asarray(x[:, i:i + 1]),
                                      positions=jnp.asarray(pos[i:i + 1]),
                                      cache=jc)
        got, pc = port_attn.mla_apply(
            mla, pcfg, torch.from_numpy(x[:, i:i + 1]),
            positions=torch.from_numpy(pos[i:i + 1]), cache=pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"decode at {i}", **TOL)
    for leaf in ("c_kv", "k_rope"):
        np.testing.assert_allclose(pc[leaf].numpy(), np.asarray(jc[leaf]),
                                   **TOL)
    assert pc["pos"] == PROMPT + 3


def _mla_pair(q_lora=0):
    """(reference params, reference config, port MLA, port config) on the
    same seeded weights."""
    from repro.configs import deepseek_v2_lite_16b as jax_ds
    from repro.models import attention as jax_attn
    jcfg = dataclasses.replace(
        jax_ds.SMOKE, mla=dataclasses.replace(jax_ds.SMOKE.mla,
                                              q_lora_rank=q_lora))
    pcfg = dataclasses.replace(
        port_ds.SMOKE, mla=dataclasses.replace(port_ds.SMOKE.mla,
                                               q_lora_rank=q_lora))
    jp = jax_attn.mla_init(jax.random.PRNGKey(3), jcfg)
    mla = port_attn.MLA(pcfg)
    flat = convert._flatten(jax.tree.map(np.asarray, jp))
    mla.load_state_dict({k: torch.tensor(v) for k, v in flat.items()},
                        strict=True)
    return jp, jcfg, mla.requires_grad_(False), pcfg


@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_continuation_and_per_slot_decode_match(q_lora):
    """MLA's continuation prefill (the compressed prefix decompressed and
    masked to pos + s) in uneven chunks, then absorbed decode steps on a
    per-slot cache whose rows sit at different depths, one of them past
    the cache (a free lane: it writes nothing and attends to every key);
    outputs and the compressed cache against the reference at 5e-6."""
    from repro.models import attention as jax_attn
    jp, jcfg, mla, pcfg = _mla_pair(q_lora)
    jcfg, pcfg = (dataclasses.replace(c, prefill_continuation=True)
                  for c in (jcfg, pcfg))
    t = 16
    x = _normal(11, BATCH, 11, pcfg.d_model)
    jc = jax_attn.mla_cache_init(jcfg, BATCH, t, jnp.float32)
    pc = port_attn.mla_cache_init(pcfg, BATCH, t, torch.float32)
    lo = 0
    for n in (4, 2, 5):
        pos = np.arange(lo, lo + n)
        want, jc = jax_attn.mla_apply(jp, jcfg, jnp.asarray(x[:, lo:lo + n]),
                                      positions=jnp.asarray(pos), cache=jc)
        got, pc = port_attn.mla_apply(mla, pcfg,
                                      torch.from_numpy(x[:, lo:lo + n]),
                                      positions=torch.from_numpy(pos),
                                      cache=pc)
        lo += n
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"chunk ending at {lo}", **TOL)
    assert pc["pos"] == lo
    rows = np.asarray([lo, t + 2], np.int32)        # row 1 past the cache
    jc = dict(jc, pos=jnp.asarray(rows))
    pc = dict(pc, pos=torch.from_numpy(rows))
    for step in range(3):
        xs = _normal(20 + step, BATCH, 1, pcfg.d_model)
        pos = (rows + step)[:, None]
        want, jc = jax_attn.mla_apply(jp, jcfg, jnp.asarray(xs),
                                      positions=jnp.asarray(pos), cache=jc)
        got, pc = port_attn.mla_apply(mla, pcfg, torch.from_numpy(xs),
                                      positions=torch.from_numpy(pos),
                                      cache=pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"per-slot step {step}", **TOL)
    for leaf in ("c_kv", "k_rope"):
        np.testing.assert_allclose(pc[leaf].numpy(), np.asarray(jc[leaf]),
                                   **TOL)
    assert pc["pos"].tolist() == (rows + 3).tolist()
    with pytest.raises(ValueError, match="decode-only"):
        port_attn.mla_apply(mla, pcfg, torch.from_numpy(x[:, :2]),
                            positions=torch.zeros(BATCH, 2).long(), cache=pc)


# ------------------------------------------------------------ the model ----
@pytest.mark.parametrize("seq", [12, 5])
def test_forward_logits_and_aux_match(weights, seq):
    from repro.configs import deepseek_v2_lite_16b as jax_ds
    from repro.models import transformer as jax_tf
    params, model = weights
    toks = _tokens(0, (BATCH, seq))
    want, want_aux = jax_tf.forward(jax_ds.SMOKE, params, jnp.asarray(toks))
    got, aux = port_model.forward(port_ds.SMOKE, model,
                                  {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    assert aux.item() > 0


@pytest.mark.parametrize("moe", [RAGGED, DENSE, {}],
                         ids=["ragged", "dense-dropless", "shipped-icf"])
def test_cached_prefill_and_decode_match(weights, moe):
    """The reference's jitted, scanned decode step always takes its dense
    path (traced routing); the port's ragged route must give the same
    logits, since dropless routes compute the same function."""
    from repro.models import transformer as jax_tf
    params, model = weights
    jcfg, pcfg = _jcfg(**(DENSE if moe is RAGGED else moe)), _pcfg(**moe)
    toks = _tokens(1, (BATCH, PROMPT + STEPS))
    jstep = jax.jit(functools.partial(jax_tf.decode_step, jcfg))
    jcache = jax_tf.init_cache(jcfg, BATCH, PROMPT + STEPS, jnp.float32)
    pcache = port_model.init_cache(pcfg, BATCH, PROMPT + STEPS,
                                   torch.float32)
    assert list(pcache) == ["blocks_dense", "blocks"]
    before = port_gg.launches
    for lo, hi in [(0, PROMPT)] + [(i, i + 1)
                                    for i in range(PROMPT, PROMPT + STEPS)]:
        want, jcache = jstep(params, jnp.asarray(toks[:, lo:hi]), jcache)
        got, pcache = port_model.decode_step(
            pcfg, model, {"tokens": torch.from_numpy(toks[:, lo:hi]).long()},
            pcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"tokens {lo}:{hi}", **LOGIT_TOL)
    assert port_gg.launches == before
    for name in ("blocks_dense", "blocks"):
        np.testing.assert_allclose(
            pcache[name][0]["c_kv"].numpy(),
            np.asarray(jcache[name]["c_kv"][0]), **TOL)
    assert pcache["blocks"][0]["pos"] == PROMPT + STEPS


@pytest.mark.parametrize("moe", [RAGGED, DENSE],
                         ids=["ragged", "dense-dropless"])
def test_greedy_tokens_match_reference_engine(weights, moe):
    from repro.serve.engine import Engine, ServeConfig
    params, model = weights
    prompts = _tokens(2, (BATCH, PROMPT))
    want = Engine(_jcfg(**DENSE), params,
                  ServeConfig(batch=BATCH, max_len=32, warmup=False,
                              kernel_plan="direct")
                  ).generate(jnp.asarray(prompts), STEPS)
    eng = port_engine.Engine(_pcfg(**moe), model,
                             port_engine.ServeConfig(batch=BATCH, max_len=32),
                             device="cpu")
    got = eng.generate(torch.from_numpy(prompts).long(), STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_runs_moe_ragged_on_cpu(capsys):
    from repro_torch.launch import serve
    before = port_gg.launches
    out = serve.main(["--arch", "deepseek-v2-lite-16b", "--smoke", "--device",
                      "cpu", "--moe-ragged", "--batch", "2", "--prompt-len",
                      "9", "--new", "4"])
    assert tuple(out.shape) == (2, 4)
    assert port_gg.launches == before
    assert "deepseek-v2-lite-smoke on cpu (xla_chunked, MoE ragged grouped " \
        "GEMM)" in capsys.readouterr().out


def test_moe_ragged_switch_needs_an_moe_config():
    from repro_torch.configs import qwen3_0_6b
    from repro_torch.launch import serve
    cfg = serve.moe_ragged(port_ds.CONFIG)
    assert cfg.moe.ragged_dropless and cfg.moe.inference_capacity_factor == 0
    with pytest.raises(ValueError, match="no MoE"):
        serve.moe_ragged(qwen3_0_6b.CONFIG)
