"""The port's data stream and training sizes held to the JAX package, on
the CPU.

- ``randint`` and ``bernoulli`` bit for bit against ``jax.random``,
  ``normal`` within 1e-5 (abs and rel: ``erfinv``'s float32
  approximations differ by a few ulps, up to 2e-5 at |x| 4);
- ``synthetic_batch`` and ``example_batch`` tokens and labels bit for bit
  for several seeds, steps and pump factors, frames and patches within
  ``normal``'s tolerance;
- ``param_count``, ``active_param_count``, ``SHAPES``, ``ARCH_IDS`` and
  ``cells`` equal to the reference's;
- ``plan_trainer_pump`` at the H100's constants, worked by hand, and the
  trainer's ``resolve_pump`` on one card.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import load_arch as jload  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.core import pump_plan  # noqa: E402
from repro_torch.data import pipeline as pdata  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402
from repro_torch.serve import prng  # noqa: E402
from repro_torch.train import trainer as ptrainer  # noqa: E402

NORMAL_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch):
    """(reference cfg, port cfg) of a SMOKE arch."""
    return jload(arch, smoke=True), pbase.load_arch(arch, smoke=True)


# ------------------------------------------------------------ data stream --
@pytest.mark.parametrize("lo,hi", [(0, 256), (0, 151936), (0, 1000),
                                   (-5, 7), (3, 3), (7, 2), (0, 65537),
                                   (-2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("seed", [0, 1234, 2 ** 31 + 5])
def test_randint_and_bernoulli_match_jax_bits(seed, lo, hi):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.randint(key, (3, 37), lo, hi))
    got = prng.randint(prng.PRNGKey(seed), (3, 37), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    p = 0.05 if lo < hi else 0.5
    np.testing.assert_array_equal(
        prng.bernoulli(prng.PRNGKey(seed), p, (4, 300)).numpy(),
        np.asarray(jax.random.bernoulli(key, p, (4, 300))))


@pytest.mark.parametrize("seed", [0, 1, 1234])
def test_normal_matches_jax(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (64, 513)))
    got = prng.normal(prng.PRNGKey(seed), (64, 513)).numpy()
    np.testing.assert_allclose(got, want, **NORMAL_TOL)
    assert np.abs(want).max() > 3.5          # the tails are drawn


@pytest.mark.parametrize("pump", [1, 2, 4])
@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-base",
                                  "internvl2-2b"])
def test_synthetic_batch_matches_reference(arch, seed, step, pump):
    jcfg, pcfg = _pair(arch)
    want = jdata.synthetic_batch(jcfg, JShape("t", 40, 8, "train"),
                                 jdata.DataConfig(seed=seed), step,
                                 pump_factor=pump)
    got = pdata.synthetic_batch(pcfg, pbase.ShapeConfig("t", 40, 8, "train"),
                                pdata.DataConfig(seed=seed), step,
                                pump_factor=pump)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert tuple(got[k].shape) == v.shape
        if k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), v)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, **NORMAL_TOL)
    lab = got["labels"].reshape(8, 40)
    assert (lab[:, -1] == -100).all()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-base",
                                  "internvl2-2b"])
def test_example_batch_matches_reference(arch):
    jcfg, pcfg = _pair(arch)
    for key in (None, 7):
        want = jmodel.example_batch(
            jcfg, JShape("s", 32, 2, "train"),
            None if key is None else jax.random.PRNGKey(key))
        got = pmodel.example_batch(
            pcfg, pbase.ShapeConfig("s", 32, 2, "train"),
            None if key is None else prng.PRNGKey(key))
        for k, v in want.items():
            if k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
            else:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                           **NORMAL_TOL)


# ------------------------------------------------------------------- pump --
def test_plan_trainer_pump_on_h100_constants():
    """Worked by hand: a ring all-reduce over d = max(dp, 2) moves
    2 (d - 1) / d of the gradient over NVLink's 450 GB/s; M doubles until
    the collective / M is under 10 % of M microbatches' compute."""
    assert pump_plan.LINK_BW == 450e9
    assert pump_plan.PEAK_FLOPS_BF16 == 989e12
    # qwen3-0.6b, fp32 gradient, 8 x 2048 tokens on one card: the
    # collective (d = 2) is 2.38 GB / 450 GB/s = 5.29 ms; a microbatch,
    # 5.86e13 FLOP / 989 TFLOP/s = 59.3 ms; 5.29 / M <= 5.93 M at M 1
    cfg = pbase.load_arch("qwen3-0.6b")
    grad = cfg.param_count() * 4
    flops = 6.0 * cfg.active_param_count() * 8 * 2048
    coll = grad / 450e9
    assert coll == pytest.approx(5.29e-3, rel=1e-2)
    assert flops / 989e12 == pytest.approx(59.3e-3, rel=1e-2)
    assert pump_plan.plan_trainer_pump(grad, flops, 1, 1) == 1
    # 1 GB of gradient, 1e12 FLOP a step on one card: coll = 2.222 ms,
    # compute 1.011 ms: M 1: 2.222 > 0.101; M 2: 1.111 > 0.202;
    # M 4: 0.556 > 0.404; M 8: 0.278 <= 0.809 -> 8
    assert pump_plan.plan_trainer_pump(int(1e9), 1e12, 1, 1) == 8
    # dp 16: 2 * 15 / 16 * 1e9 / 450e9 = 4.167 ms; 16 chips share 1.6e13
    # FLOP: 1.011 ms a chip -> M 8: 0.521 > 0.809? no: 0.521 <= 0.809 -> 8;
    # at 1e13 FLOP (0.632 ms a chip) M 8: 0.521 > 0.506 -> 16
    assert pump_plan.plan_trainer_pump(int(1e9), 1.6e13, 16, 16) == 8
    assert pump_plan.plan_trainer_pump(int(1e9), 1e13, 16, 16) == 16
    assert pump_plan.plan_trainer_pump(int(1e15), 1e9, 1, 1) == 64
    assert pump_plan.plan_trainer_pump(int(1e9), 0.0, 1, 1) == 1


def test_resolve_pump_on_one_card():
    cfg = pbase.load_arch("qwen3-0.6b")
    shape = pbase.ShapeConfig("t", 2048, 8, "train")
    assert ptrainer.resolve_pump(cfg, shape, 4) == 4
    assert ptrainer.resolve_pump(cfg, shape, "auto") == \
        pump_plan.plan_trainer_pump(cfg.param_count() * 4,
                                    6.0 * cfg.active_param_count() * 16384,
                                    1, 1)


@pytest.mark.parametrize("arch", pbase.ARCH_IDS)
def test_param_counts_and_shapes_match_reference(arch):
    from repro.configs import base as jbase
    jcfg, pcfg = jload(arch), pbase.load_arch(arch)
    assert pcfg.param_count() == jcfg.param_count()
    assert pcfg.active_param_count() == jcfg.active_param_count()
    assert {k: dataclasses.asdict(v) for k, v in pbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert pbase.ARCH_IDS == jbase.ARCH_IDS
    assert pbase.FULL_ATTENTION_ARCHS == jbase.FULL_ATTENTION_ARCHS
    for skipped in (False, True):
        assert pbase.cells(skipped) == jbase.cells(skipped)


def test_qwen3_sizes():
    """qwen3-0.6b's sizes the chip phase is planned on: 596 M parameters
    (1.19 GB in bf16, 7.15 GB of fp32 master, m and v); 218.5 M at 4
    layers (the drill's cut)."""
    cfg = pbase.load_arch("qwen3-0.6b")
    n = cfg.param_count()
    assert math.isclose(n / 1e6, 596.0, rel_tol=2e-3)
    assert math.isclose(n * 2 / 1e9, 1.19, rel_tol=5e-3)
    assert math.isclose(n * 12 / 1e9, 7.15, rel_tol=5e-3)
    cut = dataclasses.replace(cfg, n_layers=4).param_count()
    assert math.isclose(cut / 1e6, 218.5, rel_tol=2e-3)
