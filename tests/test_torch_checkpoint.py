"""Checkpoints and failover of the port, on the CPU: the reference's
checkpoint, failover and resume tests (``tests/test_system.py``) on the
port's modules, and the port's own:

- a round trip is bit-exact for every dtype, bf16 (stored as its raw 16
  bits) and NaN / inf / -0 included; the layout is the reference's
  (``step_XXXXXXXX/manifest.json`` + ``shard_00000.npz``, sha256 per
  shard, ``LATEST`` last, no ``.tmp`` left behind) and the leaves are
  named by the state's dict keys;
- ``run_with_recovery`` resumes after an injected failure exactly as the
  JAX package's does (same final state, same counter deltas), and re-raises
  a ``KernelError`` instead of restoring (the port's one divergence);
- a trainer resumed from a checkpoint equals an uninterrupted one bit for
  bit: params, master, moments, step, the data stream's step and the
  losses after the resume point.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs, optim  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.kernels._build import InputError, KernelError  # noqa: E402
from repro_torch.runtime import failover  # noqa: E402
from repro_torch.train.trainer import TrainConfig, train  # noqa: E402

TINY = ModelConfig("tiny", "dense", 2, 32, 4, 2, 64, 64, dtype="float32")
SHAPE = ShapeConfig("t", 32, 8, "train")


def _ctr(name):
    return obs.snapshot(include_views=False)["counters"].get(name, 0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


# -------------------------------------------------------------- checkpoint --
def test_checkpoint_roundtrip(tmp_path):
    """The reference's round trip: a nested state with a bf16 leaf."""
    root = str(tmp_path / "ckpt")
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "nested": {"b": torch.ones((5,), dtype=torch.bfloat16)}}
    ckpt.save(root, 7, state, extra={"step": 7})
    latest = ckpt.latest_valid(root)
    assert latest and latest.endswith("step_00000007")
    restored, extra = ckpt.restore(latest, state)
    assert extra["step"] == 7
    assert torch.equal(restored["w"], state["w"])
    assert restored["nested"]["b"].dtype == torch.bfloat16


def test_checkpoint_roundtrip_is_bit_exact_for_every_dtype(tmp_path):
    gen = torch.Generator().manual_seed(0)
    f32 = torch.randn(64, generator=gen)
    f32[:4] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0])
    raw16 = torch.randint(-2 ** 15, 2 ** 15, (33,), generator=gen,
                          dtype=torch.int16)
    state = {"params": {"blocks.0.w": f32, "embed.e": raw16.view(
        torch.bfloat16), "h": torch.randn(3, 5, generator=gen).half()},
        "opt_state": {"step": torch.tensor(3, dtype=torch.int32),
                      "i8": torch.arange(-5, 5, dtype=torch.int8),
                      "i64": torch.arange(7), "mask": torch.rand(
                          9, generator=gen) > 0.5,
                      "f64": torch.randn(4, dtype=torch.float64,
                                         generator=gen)}}
    root = str(tmp_path / "c")
    ckpt.save(root, 1, state, extra={"step": 1, "data_step": 1})
    restored, _ = ckpt.restore(ckpt.latest_valid(root), state)
    got, want = _flat(restored), _flat(state)
    assert list(got) == list(want)
    for name in want:
        assert _bits_equal(got[name], want[name]), name
    # and without a ``like``: the same tree, on the CPU
    plain, _ = ckpt.restore(os.path.join(root, "step_00000001"))
    assert all(_bits_equal(_flat(plain)[n], want[n]) for n in want)


def test_checkpoint_layout(tmp_path):
    root = str(tmp_path / "ck")
    state = {"params": {"a.b": torch.ones(2, 3, dtype=torch.bfloat16)},
             "opt_state": {"step": torch.tensor(4, dtype=torch.int32)}}
    final = ckpt.save(root, 4, state, extra={"step": 4, "data_step": 9})
    assert sorted(os.listdir(root)) == ["LATEST", "step_00000004"]
    assert sorted(os.listdir(final)) == ["manifest.json", "shard_00000.npz"]
    with open(os.path.join(root, "LATEST")) as f:
        assert f.read() == "step_00000004"
    with open(os.path.join(final, "manifest.json")) as f:
        man = json.load(f)
    assert man["paths"] == ["params/a.b", "opt_state/step"]
    assert man["dtypes"] == ["bfloat16", "int32"]
    assert man["shapes"] == [[2, 3], []]
    assert man["extra"] == {"step": 4, "data_step": 9}
    import hashlib
    with open(os.path.join(final, "shard_00000.npz"), "rb") as f:
        assert man["shards"]["shard_00000.npz"] == \
            hashlib.sha256(f.read()).hexdigest()
    with np.load(os.path.join(final, "shard_00000.npz")) as data:
        assert data["leaf_00000"].dtype == np.uint16     # bf16's raw bits
    with pytest.raises(ValueError, match="holds"):
        ckpt.save(root, 5, {"a/b": torch.ones(1)})


def test_restore_refuses_another_state(tmp_path):
    root = str(tmp_path / "ck")
    ckpt.save(root, 1, {"w": torch.ones(3)}, extra={"step": 1})
    with pytest.raises(ValueError, match="leaves differ"):
        ckpt.restore(ckpt.latest_valid(root), {"v": torch.ones(3)})
    with pytest.raises(ValueError, match="the state's"):
        ckpt.restore(ckpt.latest_valid(root), {"w": torch.ones(4)})


def test_checkpoint_detects_corruption(tmp_path):
    root = str(tmp_path / "ckpt")
    state = {"w": torch.ones((4,))}
    ckpt.save(root, 1, state, extra={"step": 1})
    ckpt.save(root, 2, state, extra={"step": 2})
    shard = os.path.join(root, "step_00000002", "shard_00000.npz")
    with open(shard, "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    latest = ckpt.latest_valid(root)
    assert latest is not None and latest.endswith("step_00000001")
    assert not ckpt.verify(os.path.join(root, "step_00000002"))


def test_checkpoint_prune(tmp_path):
    root = str(tmp_path / "ckpt")
    for s in range(6):
        ckpt.save(root, s, {"w": torch.zeros(1)}, extra={"step": s})
    ckpt.prune(root, keep=2)
    assert ckpt.available_steps(root) == [4, 5]


# ---------------------------------------------------------------- failover --
def _flaky(fail_at):
    calls = {"fail_at": fail_at}

    def train_fn(state, step):
        if step == calls["fail_at"]:
            calls["fail_at"] = None            # fail exactly once
            raise failover.FailureInjected("simulated node loss")
        return {"x": state["x"] + 1.0}
    return train_fn


def test_run_with_recovery_resumes_after_injected_failure(tmp_path):
    restarts = _ctr("failover.restart")
    final = failover.run_with_recovery(
        _flaky(7), {"x": torch.zeros(())}, n_steps=12,
        ckpt_root=str(tmp_path / "ckpt"), ckpt_every=5)
    # exactly-once semantics: the final state reflects 12 effective steps
    assert float(final["x"]) == 12.0
    assert _ctr("failover.restart") == restarts + 1


def test_run_with_recovery_matches_reference(tmp_path):
    """The JAX package's loop on the same schedule of failures: the same
    final state, checkpoints at the same steps, the same restart count."""
    jax = pytest.importorskip("jax")
    from repro import obs as jobs
    from repro.checkpoint import manager as jckpt
    from repro.runtime import failover as jfailover

    def jflaky(fail_at):
        calls = {"fail_at": fail_at}

        def train_fn(state, step):
            if step == calls["fail_at"]:
                calls["fail_at"] = None
                raise jfailover.FailureInjected("simulated node loss")
            return {"x": state["x"] + 1.0}
        return train_fn

    def jctr(name):
        return jobs.snapshot(include_views=False)["counters"].get(name, 0)

    j0, p0 = jctr("failover.restart"), _ctr("failover.restart")
    jfinal = jfailover.run_with_recovery(
        jflaky(3), {"x": jax.numpy.zeros(())}, n_steps=9,
        ckpt_root=str(tmp_path / "j"), ckpt_every=2)
    pfinal = failover.run_with_recovery(
        _flaky(3), {"x": torch.zeros(())}, n_steps=9,
        ckpt_root=str(tmp_path / "p"), ckpt_every=2)
    assert float(pfinal["x"]) == float(jfinal["x"]) == 9.0
    assert ckpt.available_steps(str(tmp_path / "p")) == \
        jckpt.available_steps(str(tmp_path / "j"))
    assert _ctr("failover.restart") - p0 == jctr("failover.restart") - j0


@pytest.mark.parametrize("err", [KernelError("no nvcc"),
                                 InputError("flash_attention: no case")])
def test_run_with_recovery_reraises_kernel_errors(tmp_path, err):
    """A toolchain fault is not a node loss: it propagates, uncounted, and
    nothing is restored."""
    restarts = _ctr("failover.restart")

    def train_fn(state, step):
        if step == 2:
            raise err
        return {"x": state["x"] + 1.0}

    with pytest.raises(type(err)):
        failover.run_with_recovery(train_fn, {"x": torch.zeros(())},
                                   n_steps=5, ckpt_root=str(tmp_path / "c"),
                                   ckpt_every=1)
    assert _ctr("failover.restart") == restarts
    assert ckpt.available_steps(str(tmp_path / "c")) == [1, 2]


def test_run_with_recovery_gives_up_after_max_restarts(tmp_path):
    def train_fn(state, step):
        raise failover.FailureInjected("always")

    with pytest.raises(failover.FailureInjected):
        failover.run_with_recovery(train_fn, {"x": torch.zeros(())},
                                   n_steps=3, ckpt_root=str(tmp_path / "c"),
                                   max_restarts=2)


def test_heartbeat_and_straggler_policy():
    hb = failover.Heartbeat(timeout_s=10)
    hb.stamp(0, 5, now=100.0)
    hb.stamp(1, 4, now=100.0)
    assert hb.dead_workers(now=105.0) == []
    assert hb.dead_workers(now=115.0) == [0, 1]
    assert hb.slowest() == 1

    pol = failover.StragglerPolicy(base_pump=8)
    for w, t in [(0, 1.0), (1, 1.0), (2, 4.0)]:
        for _ in range(20):
            pol.observe(w, t)
    pf = pol.pump_factors()
    assert pf[0] == 8 and pf[1] == 8
    assert pf[2] < 8                            # the straggler gets derated


# ------------------------------------------------------------------ resume --
def _opt():
    return optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)


def _quiet(*a, **k):
    pass


@pytest.mark.parametrize("pump", [1, 4])
def test_trainer_checkpoint_resume_bitexact(tmp_path, pump):
    """10 steps with a checkpoint every 5, resumed to 15, equal a fresh run
    of 15 bit for bit (the reference holds its resume to 1e-6)."""
    root = str(tmp_path / "ck")
    tc = dict(ckpt_every=5, log_every=1, pump_factor=pump)
    train(TINY, SHAPE, _opt(), TrainConfig(n_steps=10, ckpt_root=root, **tc),
          device="cpu", log=_quiet)
    logs = []
    out2 = train(TINY, SHAPE, _opt(), TrainConfig(n_steps=15, ckpt_root=root,
                                                  **tc),
                 device="cpu", log=logs.append)
    assert any("resumed from" in line and "step_00000010" in line
               for line in logs)
    out3 = train(TINY, SHAPE, _opt(), TrainConfig(n_steps=15, **tc),
                 device="cpu", log=_quiet)
    s2, s3 = out2["final_state"], out3["final_state"]
    assert s2.step == s3.step == 15
    t2, t3 = _flat(s2.tree()), _flat(s3.tree())
    assert list(t2) == list(t3)
    for name in t3:
        assert _bits_equal(t2[name], t3[name]), name
    assert [h["loss"] for h in out2["history"]] == \
        [h["loss"] for h in out3["history"]][10:]
    with open(os.path.join(root, "step_00000015", "manifest.json")) as f:
        extra = json.load(f)["extra"]
    assert extra == {"step": 15, "data_step": 15}


def test_trainer_checkpoint_holds_bf16_params_and_names(tmp_path):
    root = str(tmp_path / "ck")
    out = train(TINY, SHAPE, _opt(),
                TrainConfig(n_steps=2, ckpt_root=root, ckpt_every=1,
                            param_dtype="bfloat16", log_every=1),
                device="cpu", log=_quiet)
    assert ckpt.available_steps(root) == [1, 2]
    state = out["final_state"]
    tree, extra = ckpt.restore(ckpt.latest_valid(root), state.tree())
    assert extra == {"step": 2, "data_step": 2}
    names = list(_flat(tree))
    assert "params/embed.embedding" in names
    assert "opt_state/master/blocks.0.attn.wq.w" in names
    assert "opt_state/step" in names
    assert tree["params"]["embed.embedding"].dtype == torch.bfloat16
    assert tree["opt_state"]["master"]["embed.embedding"].dtype == \
        torch.float32
    for name, t in _flat(state.tree()).items():
        assert _bits_equal(_flat(tree)[name], t), name


def test_trainer_resumes_the_data_stream(tmp_path):
    """A resumed run's next batch is the one the interrupted run would have
    drawn: the data step comes back from the checkpoint."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    root = str(tmp_path / "ck")
    seen = []
    import repro_torch.train.trainer as trainer_mod
    real = trainer_mod.DataIterator.__next__

    def spy(self):
        seen.append(self.step)
        return real(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(trainer_mod.DataIterator, "__next__", spy)
    try:
        train(TINY, SHAPE, _opt(), TrainConfig(n_steps=3, ckpt_root=root,
                                               ckpt_every=3),
              device="cpu", log=_quiet)
        train(TINY, SHAPE, _opt(), TrainConfig(n_steps=5, ckpt_root=root,
                                               ckpt_every=3),
              device="cpu", log=_quiet)
    finally:
        mp.undo()
    assert seen == [0, 1, 2, 3, 4]
    assert synthetic_batch(TINY, SHAPE, DataConfig(seed=0), 3)["tokens"] \
        .shape == (8, 32)
