"""The port's optimizer, train step and trainer held to the JAX package, on
the CPU:

- ``adamw.schedule`` and ``adamw.update`` on identical gradients (fp32
  and bf16 moments, with and without clipping) within 1e-6 relative, and
  ``compress.quantize`` exact (int8 round half to even, error feedback);
- ``make_train_step`` at M 1 and M 4 against the JAX step from the same
  params and batch, M 4 against M 1 (the reference's own identity, 1e-5),
  and M 4's fp32 accumulation of bf16 microbatch gradients;
- a trainer run from the same params against the JAX trainer (bounds at
  ``TRAINER_*``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import optim as jopt  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import load_arch as jload  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.data import pipeline as pdata  # noqa: E402
from repro_torch.launch import steps as psteps  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402
from repro_torch.optim import compress  # noqa: E402
from repro_torch.train import trainer as ptrainer  # noqa: E402

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch):
    """(reference cfg, port cfg) of a SMOKE arch."""
    return jload(arch, smoke=True), pbase.load_arch(arch, smoke=True)


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaf_pairs(pcfg, jtree):
    """(port name, reference leaf) of every leaf of a reference tree, the
    stacked segments un-stacked as ``convert`` loads them."""
    stacked = tuple(f"{n}." for n in convert._stacked(pcfg))
    for name, arr in convert._flatten(_np(jtree)).items():
        seg = next((p for p in stacked if name.startswith(p)), None)
        if seg is None:
            yield name, arr
        else:
            for i in range(arr.shape[0]):
                yield f"{seg}{i}.{name[len(seg):]}", arr[i]


# -------------------------------------------------------------- optimizer --
def _seeded(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (7, 5), "b": (33,), "c": (4, 4, 3)}


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 10000, 20000])
def test_schedule_matches_reference(step):
    cfg = optim.AdamWConfig()
    jcfg = jopt.AdamWConfig()
    want = float(jopt.schedule(jcfg, jnp.asarray(step, jnp.int32)))
    got = float(optim.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


class _Params(torch.nn.Module):
    def __init__(self, arrays, dtype):
        super().__init__()
        for k, v in arrays.items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.from_numpy(v).to(dtype)))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0, 1e-3])
def test_adamw_update_matches_reference(moments, clip):
    fields = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip,
                  moment_dtype=moments)
    jcfg, cfg = jopt.AdamWConfig(**fields), optim.AdamWConfig(**fields)
    p0 = _seeded(SHAPES, 0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jcfg, jp)
    model = _Params(p0, torch.float32)
    state = optim.init(cfg, model)
    for i in range(4):
        g = _seeded(SHAPES, 10 + i)
        jp, jstate, jm = jopt.update(
            jcfg, {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        m = optim.update(cfg, {k: torch.from_numpy(v) for k, v in g.items()},
                         state, model)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for k in SHAPES:
            for got, want in ((getattr(model, k), jp[k]),
                              (state.master[k], jstate.master[k]),
                              (state.m[k], jstate.m[k]),
                              (state.v[k], jstate.v[k])):
                np.testing.assert_allclose(
                    got.detach().float().numpy(),
                    np.asarray(want).astype(np.float32), rtol=1e-6,
                    atol=1e-6 if moments == "float32" else 1e-2 * float(
                        np.abs(np.asarray(want, np.float32)).max()))
    assert int(state.step) == int(jstate.step) == 4
    assert state.m["a"].dtype == getattr(torch, moments)


def test_adamw_bf16_params_keep_an_fp32_master():
    cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    model = _Params(_seeded(SHAPES, 0), torch.bfloat16)
    state = optim.init(cfg, model)
    assert all(t.dtype == torch.float32 for t in state.master.values())
    g = {k: torch.from_numpy(v) for k, v in _seeded(SHAPES, 1).items()}
    optim.update(cfg, g, state, model)
    for k in SHAPES:
        assert getattr(model, k).dtype == torch.bfloat16
        assert torch.equal(getattr(model, k), state.master[k].bfloat16())


@pytest.mark.parametrize("with_err", [False, True])
def test_compress_quantize_matches_reference_exactly(with_err):
    from repro.optim import compress as jcomp
    shapes = {"a": (300,), "b": (16, 40), "z": (5,)}
    g = _seeded(shapes, 3)
    g["z"][:] = 0.0
    g["a"][7] = 0.5 * g["a"].max() / 127.0 * 3     # near a rounding tie
    err = _seeded(shapes, 4) if with_err else None
    jq, jerr = jcomp.quantize({k: jnp.asarray(v) for k, v in g.items()},
                              None if err is None else
                              {k: jnp.asarray(v) for k, v in err.items()})
    q, perr = compress.quantize(
        {k: torch.from_numpy(v) for k, v in g.items()},
        None if err is None else {k: torch.from_numpy(v)
                                  for k, v in err.items()})
    for k in shapes:
        np.testing.assert_array_equal(q[k][0].numpy(), np.asarray(jq[k][0]))
        np.testing.assert_array_equal(q[k][1].numpy(), np.asarray(jq[k][1]))
        np.testing.assert_array_equal(perr[k].numpy(), np.asarray(jerr[k]))
    deq = compress.dequantize(q, {k: torch.from_numpy(v)
                                  for k, v in g.items()})
    jdeq = jcomp.dequantize(jq, {k: jnp.asarray(v) for k, v in g.items()})
    for k in shapes:
        np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    assert compress.compression_ratio(tg) == jcomp.compression_ratio(
        {k: jnp.asarray(v) for k, v in g.items()})


def test_compress_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5])
    q, _ = compress.quantize({"g": g})
    assert q["g"][0][0, :6].tolist() == [127, 0, 2, 2, 0, -2]


# ------------------------------------------------------------- train step --
def _tiny():
    from repro.configs.base import ModelConfig as JModelConfig
    return JModelConfig(**TINY), pbase.ModelConfig(**TINY)


def _step_pair(jcfg, pcfg, pump, optfields, batch_np, params):
    """One step of each package from ``params``; returns (JAX new params,
    metrics), (port model, metrics)."""
    jo, po = jopt.AdamWConfig(**optfields), optim.AdamWConfig(**optfields)
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    pb = _to_torch(batch_np)
    if pump > 1:
        jb = jax.tree.map(lambda a: a.reshape((pump, -1) + a.shape[1:]), jb)
        pb = {k: v.reshape((pump, -1) + v.shape[1:]) for k, v in pb.items()}
    jp, _, jm = jax.jit(jsteps.make_train_step(jcfg, jo, pump))(
        params, jopt.init(jo, params), jb)
    model = convert.from_jax_params(pcfg, _np(params))
    state = optim.init(po, model)
    pm = psteps.make_train_step(pcfg, po, pump)(model, state, pb)
    return (jp, jm), (model, pm, state)


STEP_FAR_SHARE = 1e-3


def _assert_params(model, pcfg, jparams, atol, bound, share):
    """Every element within ``bound``; all but ``share`` of them within
    ``atol``."""
    got = dict(model.named_parameters())
    n_far = n_all = 0
    for name, a in _leaf_pairs(pcfg, jparams):
        d = np.abs(got[name].detach().numpy() - a)
        assert d.max() <= bound, (name, d.max())
        n_far += int((d > atol).sum())
        n_all += d.size
    assert n_far <= share * n_all, (n_far, n_all)


@pytest.mark.parametrize("pump", [1, 4])
@pytest.mark.parametrize("arch", ["tiny", "qwen3-0.6b", "deepseek-v2-lite-16b"])
def test_train_step_matches_reference(arch, pump):
    """One step at M 1 and M 4 from the same params and batch.  Clipping
    off, lr 1e-3: at step 1 AdamW moves an element by lr · g / (|g| + eps),
    which for |g| near eps (1e-8) turns a rounding difference of g (about
    1e-7 relative between the two packages' fp32 sums) into a visible one,
    up to 2 lr where g's sign flips.  So every element is within 2 lr, and
    all but ``STEP_FAR_SHARE`` of them within 1e-6."""
    jcfg, pcfg = _tiny() if arch == "tiny" else _pair(arch)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _np(jdata.synthetic_batch(jcfg, JShape("t", 32, 8, "train"),
                                      jdata.DataConfig(), 0))
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=0.0)
    (jp, jm), (model, pm, state) = _step_pair(jcfg, pcfg, pump, opt, batch,
                                              params)
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert float(pm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    _assert_params(model, pcfg, jp, 1e-6, 2 * opt["lr"], STEP_FAR_SHARE)
    assert int(state.step) == 1


@pytest.mark.parametrize("arch", ["tiny", "mamba2-1.3b"])
def test_pumped_step_matches_unpumped(arch):
    """The reference's identity on the port: M 4 microbatches of 2 == one
    batch of 8, loss and params within 1e-5."""
    jcfg, pcfg = _tiny() if arch == "tiny" else _pair(arch)
    opt = optim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                            grad_clip=0.0)
    m1 = convert.init_params(pcfg, torch.Generator().manual_seed(0))
    m4 = convert.init_params(pcfg, torch.Generator().manual_seed(0))
    batch = pdata.synthetic_batch(pcfg, pbase.ShapeConfig("t", 32, 8,
                                                          "train"),
                                  pdata.DataConfig(), 0)
    pumped = {k: v.reshape((4, 2) + v.shape[1:]) for k, v in batch.items()}
    r1 = psteps.make_train_step(pcfg, opt)(m1, optim.init(opt, m1), batch)
    r4 = psteps.make_train_step(pcfg, opt, 4)(m4, optim.init(opt, m4), pumped)
    assert float(r1["loss"]) == pytest.approx(float(r4["loss"]), rel=1e-5)
    for (n, a), (_, b) in zip(m1.named_parameters(), m4.named_parameters()):
        assert float((a - b).detach().abs().max()) < 1e-5, n


def test_pumped_accumulates_fp32_from_bf16_params():
    """At M > 1 the microbatch gradients add up in fp32 buffers (the
    reference's fp32 zeros), not in bf16: a bf16 model's M 4 step equals
    the update from the fp32 sum of its four bf16 microbatch gradients."""
    _jcfg, pcfg = _tiny()
    pcfg = dataclasses.replace(pcfg, dtype="bfloat16")
    opt = optim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                            grad_clip=0.0)
    gen = torch.Generator().manual_seed(0)
    model = convert.init_params(pcfg, gen, dtype=torch.bfloat16)
    ref = convert.init_params(pcfg, torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16).requires_grad_(True)
    batch = pdata.synthetic_batch(pcfg, pbase.ShapeConfig("t", 32, 8,
                                                          "train"),
                                  pdata.DataConfig(), 0, pump_factor=4)
    names = [n for n, _ in ref.named_parameters()]
    acc = {n: torch.zeros(p.shape) for n, p in ref.named_parameters()}
    for i in range(4):
        loss = pmodel.loss_fn(pcfg, ref, {k: v[i] for k, v in batch.items()})
        for n, g in zip(names, torch.autograd.grad(loss,
                                                   list(ref.parameters()))):
            assert g.dtype == torch.bfloat16
            acc[n] += g
    rstate = optim.init(opt, ref)
    optim.update(opt, {n: g * 0.25 for n, g in acc.items()}, rstate, ref)
    psteps.make_train_step(pcfg, opt, 4)(model, optim.init(opt, model),
                                         batch)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              ref.named_parameters()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------- trainer --
# The trainer against the JAX trainer, 12 steps of TINY at lr 3e-3 from the
# same params and the same stream.  The two compute each gradient in fp32
# with sums in another order, about 1e-7 relative apart; AdamW divides by
# sqrt(v), so an element whose gradient is within that rounding of 0 can
# take a step of up to lr the other way.  After n steps an element can so
# differ by at most 2 lr n; the bound below allows that for the few that
# do, while every other element must agree within TRAINER_ATOL, and the
# losses (an average over all tokens) within TRAINER_LOSS_RTOL.
TRAINER_STEPS = 12
TRAINER_LR = 3e-3
TRAINER_ATOL = 1e-5
TRAINER_LOSS_RTOL = 1e-5
TRAINER_FLIP_SHARE = 1e-3


def test_trainer_matches_reference_trainer():
    from repro.train import trainer as jtrainer
    jcfg, pcfg = _tiny()
    shape = dict(name="t", seq_len=32, global_batch=8, kind="train")
    opt = dict(lr=TRAINER_LR, warmup_steps=3, total_steps=TRAINER_STEPS)
    tc = dict(n_steps=TRAINER_STEPS, log_every=1, seed=0)
    jout = jtrainer.train(jcfg, JShape(**shape), jopt.AdamWConfig(**opt),
                          jtrainer.TrainConfig(**tc), log=lambda *a: None)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.from_jax_params(pcfg, _np(params))
    pout = ptrainer.train(pcfg, pbase.ShapeConfig(**shape),
                          optim.AdamWConfig(**opt),
                          ptrainer.TrainConfig(**tc), device="cpu",
                          log=lambda *a: None, model=model)
    jl = [h["loss"] for h in jout["history"]]
    pl = [h["loss"] for h in pout["history"]]
    assert len(pl) == len(jl) == TRAINER_STEPS
    np.testing.assert_allclose(pl, jl, rtol=TRAINER_LOSS_RTOL)
    assert pl[-1] < pl[0]
    _assert_params(pout["final_state"].model, pcfg,
                   jout["final_state"].params, TRAINER_ATOL,
                   2 * TRAINER_LR * TRAINER_STEPS, TRAINER_FLIP_SHARE)


