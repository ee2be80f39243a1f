"""The reference's training tests on the port (``tests/test_system.py``'s
convergence and data-stream tests, ``tests/test_archs.py::
test_one_train_step`` for all ten SMOKE archs, ``tests/test_core.py::
test_trainer_pump_scales_with_model_size``; the train rungs of its
``tests/test_chaos.py`` are in ``tests/test_torch_chaos.py``), and the
port's own:

- remat: under grad mode each block's apply runs under
  ``torch.utils.checkpoint`` (and its gradient equals the un-remat'd
  one); under ``no_grad`` nothing is checkpointed;
- the kernels refuse autograd: ``ops.grad_refusal`` names the kernel when
  grad mode is on and an operand requires grad, and every kernel wrapper
  on a route marked CUDA raises that ``InputError`` before it launches;
  under ``no_grad`` the wrapper goes on to its kernel; CPU tensors keep
  their differentiable plain versions;
- the launcher on the CPU (``--smoke --device cpu``, ``--pump auto``,
  ``--ckpt`` resuming, ``--failover``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs, optim  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, ModelConfig,  # noqa: E402
                                      ShapeConfig, load_arch)
from repro_torch.core.pump_plan import plan_trainer_pump  # noqa: E402
from repro_torch.data.pipeline import DataIterator  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels._build import InputError  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.train.trainer import TrainConfig, train  # noqa: E402

TINY = ModelConfig("tiny", "dense", 2, 32, 4, 2, 64, 64, dtype="float32")
SHAPE = ShapeConfig("t", 32, 8, "train")
SMOKE_SHAPE = ShapeConfig("smoke", 32, 2, "train")


# ------------------------------------------------- the reference's tests --
def test_training_loss_decreases():
    """The reference's bar on the reference's own starting point: its
    ``train`` draws TINY's params from ``PRNGKey(0)``, so the port's trainer
    starts from that tree too (the port's seeded draw, ``convert.
    init_params``, is another sample of the same distributions)."""
    jax = pytest.importorskip("jax")
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import model as jmodel
    # TINY's fields that the JAX config has (the port adds rope_scaling)
    shared = {f.name: getattr(TINY, f.name)
              for f in dataclasses.fields(JModelConfig)}
    params = jmodel.init_params(JModelConfig(**shared),
                                jax.random.PRNGKey(0))
    model = convert.from_jax_params(TINY, jax.tree.map(np.asarray, params))
    out = train(TINY, SHAPE,
                optim.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=80),
                TrainConfig(n_steps=80, log_every=10), device="cpu",
                log=lambda *a: None, model=model)
    h = out["history"]
    assert h[-1]["loss"] < h[0]["loss"] * 0.95
    assert all(np.isfinite(e["loss"]) for e in h)


def test_data_stream_is_deterministic_and_checkpointable():
    it1 = DataIterator(TINY, SHAPE)
    for _ in range(3):
        next(it1)
    state = it1.state()
    b_next = next(it1)
    it2 = DataIterator.from_state(TINY, SHAPE, state)
    b_replay = next(it2)
    assert torch.equal(b_next["tokens"], b_replay["tokens"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_train_step(arch):
    cfg = load_arch(arch, smoke=True)
    optcfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt_state = optim.init(optcfg, model)
    step = steps_mod.make_train_step(cfg, optcfg)
    batch = model_mod.example_batch(cfg, SMOKE_SHAPE)
    metrics = step(model, opt_state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    moved = [float((p.detach() - before[n]).abs().max())
             for n, p in model.named_parameters()]
    assert max(moved) > 0
    assert all(p.requires_grad for p in model.parameters())


def test_trainer_pump_scales_with_model_size():
    small = plan_trainer_pump(grad_bytes=int(1e8), step_flops=1e15,
                              n_chips=256, dp_degree=16)
    big = plan_trainer_pump(grad_bytes=int(1e12), step_flops=1e15,
                            n_chips=256, dp_degree=16)
    assert big >= small


def test_straggler_derate_is_counted(monkeypatch):
    """A derate moves ``train.pump_derate`` and is logged."""
    from repro_torch.runtime import failover
    pol = failover.StragglerPolicy()
    monkeypatch.setattr(pol, "pump_factors", lambda: {0: 2})
    before = obs.snapshot(include_views=False)["counters"].get(
        "train.pump_derate", 0)
    logs = []
    train(TINY, SHAPE, optim.AdamWConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=3),
          TrainConfig(n_steps=3, pump_factor=4), device="cpu",
          straggler=pol, log=logs.append)
    after = obs.snapshot(include_views=False)["counters"].get(
        "train.pump_derate", 0)
    assert after == before + 1
    assert any("derated pump 4 -> 2" in line for line in logs)
    assert obs.snapshot(include_views=False)["gauges"][
        "train.pump_derated"] == 2


# ------------------------------------------------------------------ remat --
def test_remat_wraps_blocks_only_under_grad(monkeypatch):
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    for arch, want in (("qwen3-0.6b", 2), ("zamba2-2.7b", None),
                       ("whisper-base", None)):
        cfg = load_arch(arch, smoke=True)
        model = convert.init_params(cfg, torch.Generator().manual_seed(0))
        batch = model_mod.example_batch(cfg, SMOKE_SHAPE)
        calls.clear()
        with torch.no_grad():
            model_mod.loss_fn(cfg, model, batch)
        assert calls == []
        model.requires_grad_(True)
        model_mod.loss_fn(cfg, model, batch).backward()
        if arch == "zamba2-2.7b":      # every Mamba-2 block + shared each group
            groups = cfg.n_layers // cfg.hybrid_attn_every
            want = cfg.n_layers + groups
        if arch == "whisper-base":
            want = (cfg.n_encoder_layers or cfg.n_layers) + cfg.n_layers
        assert len(calls) == want, (arch, calls)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-1.3b",
                                  "deepseek-v2-lite-16b"])
def test_remat_gradient_equals_plain_gradient(arch):
    cfg = load_arch(arch, smoke=True)
    batch = model_mod.example_batch(cfg, SMOKE_SHAPE)
    grads = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = convert.init_params(c, torch.Generator().manual_seed(0))
        model.requires_grad_(True)
        loss = model_mod.loss_fn(c, model, batch)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------- the kernels' refusal --
def test_grad_refusal_predicate():
    a = torch.ones(2, requires_grad=True)
    b = torch.ones(2)
    why = ops.grad_refusal("flash_attention", (b, a, 3))
    assert why is not None and why.startswith("flash_attention:")
    assert "[1]" in why and "no backward" in why
    assert ops.grad_refusal("flash_attention", (b, b)) is None
    with torch.no_grad():
        assert ops.grad_refusal("flash_attention", (a, b)) is None
    # a tensor derived from one that requires grad requires it too
    assert ops.grad_refusal("ssd_scan", (a * 2,)) is not None


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _wrapper_calls():
    """(kernel name, call(requires_grad)) for every kernel wrapper, at
    small shapes."""
    g = _gen()

    def t(*shape, grad=False):
        x = torch.randn(*shape, generator=g)
        return x.requires_grad_(grad)

    def flash(rg):
        return ops.flash_attention(t(1, 2, 8, 16, grad=rg), t(1, 1, 8, 16),
                                   t(1, 1, 8, 16), causal=True)

    def decode(rg):
        return ops.decode_attention(t(1, 2, 16), t(1, 1, 8, 16, grad=rg),
                                    t(1, 1, 8, 16), 3)

    def scan(rg):
        return ops.ssd_scan(t(1, 8, 2, 4), t(1, 8, 2).abs(), -t(2).abs(),
                            t(1, 8, 1, 4, grad=rg), t(1, 8, 1, 4), chunk=4)

    def sdecode(rg):
        return ops.ssd_decode(t(1, 2, 4, 4), t(1, 2, 4), t(1, 2).abs(),
                              -t(2).abs(), t(1, 1, 4), t(1, 1, 4, grad=rg))

    def gg(rg):
        return ops.grouped_gemm(t(2, 4, 8, grad=rg), t(2, 8, 16))

    def gg_ragged(rg):
        return ops.grouped_gemm(t(7, 8), t(3, 8, 16, grad=rg),
                                group_sizes=[4, 0, 3])

    def vecadd(rg):
        return ops.vecadd(t(64, grad=rg), t(64))

    def matmul(rg):
        return ops.matmul(t(64, 64), t(64, 64, grad=rg))

    def stencil(rg):
        return ops.stencil_chain(t(6, 8, 8, grad=rg), 1)

    def fw(rg):
        return ops.floyd_warshall(t(8, 8, grad=rg).abs())

    return [("flash_attention", flash), ("decode_attention", decode),
            ("ssd_scan", scan), ("ssd_decode", sdecode),
            ("grouped_gemm", gg), ("grouped_gemm", gg_ragged),
            ("vecadd", vecadd), ("matmul", matmul),
            ("stencil_chain", stencil), ("floyd_warshall", fw)]


@pytest.mark.parametrize("name,call", _wrapper_calls(),
                         ids=[f"{n}-{i}" for i, (n, _c)
                              in enumerate(_wrapper_calls())])
def test_every_kernel_wrapper_refuses_autograd_on_the_card(name, call,
                                                           monkeypatch):
    """On a route marked CUDA (simulated), an operand that requires grad is
    refused with an ``InputError`` naming the kernel, before any launch;
    under ``no_grad`` the wrapper goes on to the CUDA kernel (which here
    refuses the CPU tensors it was given); on the CPU the plain version
    runs and carries the gradient."""
    out = call(True)                          # CPU: the plain version
    out = out[0] if isinstance(out, tuple) else out
    assert out.requires_grad
    monkeypatch.setattr(ops, "_route", lambda x, n: True)
    with pytest.raises(InputError, match=f"^{name}: operand") as info:
        call(True)
    assert "no backward" in str(info.value)
    with torch.no_grad(), pytest.raises(Exception) as info:
        call(True)
    assert "no backward" not in str(info.value)
    with pytest.raises(Exception) as info:
        call(False)
    assert "no backward" not in str(info.value)


def test_region_map_reduce_refuses_autograd_on_the_card(monkeypatch):
    """The compiled route's kernel, ``ops.region_map_reduce``, checks all
    its operands."""
    a = torch.ones(4, requires_grad=True)
    monkeypatch.setattr(ops, "_route", lambda x, n: True)
    with pytest.raises(InputError, match="^region_map_reduce: operand"):
        ops.region_map_reduce(None, [torch.ones(4), a])


def test_plain_routes_train_on_the_cpu():
    """CPU tensors keep their differentiable plain versions: flash's plain
    version gives the gradient of the chunked attention it stands for."""
    from repro_torch.models.attention import chunked_attention
    g = _gen(1)
    q = torch.randn(1, 2, 8, 16, generator=g, requires_grad=True)
    k = torch.randn(1, 1, 8, 16, generator=g)
    v = torch.randn(1, 1, 8, 16, generator=g)
    (ga,) = torch.autograd.grad(
        ops.flash_attention(q, k, v, causal=True).sum(), q)
    (gb,) = torch.autograd.grad(
        chunked_attention(q, k, v, causal=True).sum(), q)
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-6)


def test_training_a_kernel_route_on_the_card_is_refused(monkeypatch):
    """A model on the ``pallas`` route cannot train on the card: the first
    kernel the loss reaches refuses (no silent cut in the gradient)."""
    cfg = dataclasses.replace(load_arch("qwen3-0.6b", smoke=True),
                              attention_impl="pallas", kernel_plan="direct")
    model = convert.init_params(cfg, _gen()).requires_grad_(True)
    batch = model_mod.example_batch(cfg, SMOKE_SHAPE)
    monkeypatch.setattr(ops, "_route", lambda x, n: True)
    with pytest.raises(InputError, match="^flash_attention: operand"):
        model_mod.loss_fn(cfg, model, batch)


# --------------------------------------------------------------- launcher --
def test_launcher_trains_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train as launch_train
    out = launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                             "cpu", "--steps", "4", "--pump", "4",
                             "--seq", "16", "--failover"])
    text = capsys.readouterr().out
    assert out["pump"] == 4 and out["steps"] == 4
    assert np.isfinite(out["loss_last"]) and out["peak_gib"] is None
    assert "[failover] heartbeat: 1 worker(s) stamped, 0 dead" in text
    assert text.strip().splitlines()[-1].startswith("[train] done: loss ")
    # SMOKE's 0.11 M params at 8 x 64 tokens: the collective's 1.02 us
    # against 0.36 us of compute a microbatch plans M 8
    auto = launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                              "cpu", "--steps", "1", "--pump", "auto"])
    assert auto["pump"] == 8
    with pytest.raises(ValueError, match="does not divide"):
        launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                           "cpu", "--steps", "1", "--pump", "auto", "--seq",
                           "16"])
    root = str(tmp_path / "ck")
    launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq", "16", "--ckpt", root])
    capsys.readouterr()
    again = launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                               "cpu", "--steps", "3", "--seq", "16",
                               "--ckpt", root])
    assert "resumed from" in capsys.readouterr().out
    assert again["steps"] == 1
