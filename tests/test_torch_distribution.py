"""The distribution layer on the port: the reference's
``tests/test_distribution.py`` (10 tests), test for test, and the port's
own checks.

The reference's HLO parser test becomes a test of the dry run's collective
tally on a small DTensor program with known collectives, on a fake (2, 2)
world.  Beside the reference's tests:

- param specs: for all ten configs at full width, the port's
  ``fit_specs(param_specs(...))`` on meta params equals the reference's on
  ``jax.eval_shape`` params, leaf by leaf by name, without the reference's
  leading layer axis, on 16 x 16 and 2 x 16 x 16 meshes (a stand-in mesh
  object on either side: the rules read only axis names and sizes);
- cache specs, the same, on each config's decode_32k cache;
- the optimizer state's specs widened over ("pod", "data") against the
  reference's ``train_shardings``;
- ``make_prefill_step`` / ``make_decode_step`` on the CPU host mesh
  against the JAX package's steps on the same weights (1e-4 on logits),
  and bit for bit against the direct path;
- the dry run at SMOKE on a fake (2, 2) world (a train and a decode
  cell), a failing cell making ``main`` exit 1, and the full-width
  per-device argument bytes of qwen3-0.6b x train_4k (16 x 16) and
  deepseek-v2-lite-16b x decode_32k (2 x 16 x 16) against the reference's;
- the meshes (``make_production_mesh`` refusing any other world), the
  ``__main__`` dispatcher, a DTensor refused by a kernel's launch,
  ``mesh=`` on ``Engine`` and ``train`` (and ``mesh=None`` making no
  process group), ``launch.train --production-mesh`` refused at world
  size 1, and ``examples/torch_failover_drill.py`` through its ``main``.
"""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = torch.distributed

from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial, Replicate,  # noqa: E402
                                      Shard)

from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeConfig,  # noqa: E402
                                      load_arch)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import sharding as shard_mod  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch.sharding import P  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


class StandIn:
    """A mesh as both packages' rules read it: axis names and sizes."""

    def __init__(self, shape, names):
        self.mesh_dim_names = self.axis_names = names
        self.shape = shape
        self.devices = np.empty(shape)


@pytest.fixture
def host_mesh():
    mesh = mesh_mod.make_host_mesh("cpu")
    yield mesh
    mesh_mod.destroy_group()


@pytest.fixture
def fake22():
    with mesh_mod.fake_world(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


# ----------------------------------------------------------- rule fitting --
def test_fit_drops_nondividing_axes(host_mesh):
    spec = shard_mod._fit(P("data", "model"), (3, 5), host_mesh)
    assert spec == P(None, None)   # 1-device mesh: everything replicates


def test_param_specs_cover_all_leaves():
    for arch in ("qwen3-0.6b", "deepseek-v2-lite-16b", "mamba2-1.3b",
                 "zamba2-2.7b", "whisper-base", "internvl2-2b"):
        params = steps_mod.abstract_params(load_arch(arch, smoke=True))
        specs = shard_mod.param_specs(params)
        named = dict(params.named_parameters())
        assert set(specs) == set(named)
        for name, spec in specs.items():
            assert len(spec) <= named[name].dim(), (name, spec)


def test_embedding_and_mlp_rules():
    specs = shard_mod.param_specs(
        {"embed.embedding": torch.empty(1024, 64, device="meta"),
         "mlp.down.w": torch.empty(256, 64, device="meta"),
         "mlp.up.w": torch.empty(64, 256, device="meta")})
    assert specs["embed.embedding"] == P("model", "data")
    assert specs["mlp.down.w"] == P("model", "data")     # row-parallel
    assert specs["mlp.up.w"] == P("data", "model")       # col-parallel


def test_cache_specs_head_vs_sequence_sharding():
    mesh = StandIn((1, 4), ("data", "model"))
    cache = {"k": torch.empty(4, 8, 16, 32, device="meta"),
             "v": torch.empty(4, 2, 16, 32, device="meta"),
             "pos": torch.empty(4, dtype=torch.int32, device="meta")}
    specs = shard_mod.cache_specs(cache, mesh)
    assert specs["pos"] == P()
    assert specs["k"] == P(None, "model", None, None)      # heads divide
    assert specs["v"] == P(None, None, "model", None)      # else time
    assert shard_mod.cache_specs({"pos": 0}, mesh) == {"pos": None}


# ------------------------------------------------------ collective tally --
def test_collective_tally_counts_known_collectives(fake22):
    mesh = fake22
    x = DTensor.from_local(torch.ones(4, 8), mesh, [Shard(0), Replicate()],
                           run_check=False)
    p = DTensor.from_local(torch.ones(6, 4), mesh, [Partial(), Replicate()],
                           run_check=False)
    with dryrun.CollectiveTally() as tally:
        x.redistribute(mesh, [Replicate(), Replicate()])     # all-gather
        p.redistribute(mesh, [Replicate(), Replicate()])     # all-reduce
        p.redistribute(mesh, [Shard(0), Replicate()])        # reduce-scatter
    out = tally.result()
    assert out["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 0}
    assert out["count"] == 3
    assert out["bytes"]["all-gather"] == 8 * 8 * 4        # the (8, 8) whole
    assert out["bytes"]["all-reduce"] == 6 * 4 * 4
    assert out["bytes"]["reduce-scatter"] == 3 * 4 * 4    # a (3, 4) shard


def test_collective_tally_ignores_noncollectives(fake22):
    a = DTensor.from_local(torch.ones(4, 8), fake22, [Shard(0), Replicate()],
                           run_check=False)
    b = DTensor.from_local(torch.ones(8, 8), fake22,
                           [Replicate(), Replicate()], run_check=False)
    with dryrun.CollectiveTally() as tally:
        a @ b
    out = tally.result()
    assert out["count"] == 0 and sum(out["bytes"].values()) == 0
    assert out["flops"] == 2 * 4 * 8 * 8      # this rank's (4, 8) shard


# ------------------------------------------------------------ input specs --
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-base",
                                  "internvl2-2b"])
def test_abstract_batch_shapes(arch):
    cfg = load_arch(arch)
    shape = SHAPES["train_4k"]
    batch = steps_mod.abstract_batch(cfg, shape)
    assert batch["tokens"].shape == (256, 4096)
    assert batch["tokens"].dtype == torch.int32 and batch["tokens"].is_meta
    if cfg.family == "encdec":
        assert batch["frames"].shape == (256, cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        assert batch["patches"].shape == (256, cfg.n_vision_tokens,
                                          cfg.d_vision)
    pumped = steps_mod.abstract_batch(cfg, shape, pump_factor=4)
    assert pumped["tokens"].shape == (4, 64, 4096)


def test_abstract_cache_matches_family():
    cfg = load_arch("mamba2-1.3b")
    cache = steps_mod.abstract_cache(cfg, SHAPES["decode_32k"])
    layers = cache["blocks"]
    assert len(layers) == cfg.n_layers        # one cache per layer
    for c in layers:                          # no tensor of sequence length
        assert set(c) == {"state", "conv", "pos"}
        assert all(t.is_meta and 32768 not in t.shape
                   for t in (c["state"], c["conv"]))


def test_abstract_params_cost_no_memory():
    params = steps_mod.abstract_params(load_arch("deepseek-v3-671b"))
    n = sum(p.numel() for p in params.parameters())
    assert n > 6.5e11 and all(p.is_meta for p in params.parameters())


# ----------------------------------------------- end-to-end sharded step --
def test_train_step_runs_on_host_mesh(host_mesh):
    """The reference's lower-and-compile on the host mesh: here the step
    runs placed under ``train_shardings`` (all replicated, so on the local
    tensors) and equals the direct step bit for bit."""
    cfg = load_arch("qwen3-0.6b", smoke=True)
    optcfg = optim.AdamWConfig()
    shape = ShapeConfig("t", 16, 4, "train")
    step = steps_mod.make_train_step(cfg, optcfg, pump_factor=2)
    (p_sh, o_sh, b_sh), out_sh, args = steps_mod.train_shardings(
        cfg, optcfg, host_mesh, shape, torch.float32, pump_factor=2)
    assert args[2]["tokens"].shape == (2, 2, 16)
    assert all(pl == (Replicate(), Replicate()) for pl in p_sh.values())
    batch = model_mod.example_batch(cfg, shape)
    pumped = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in batch.items()}
    base = convert.init_params(cfg, torch.Generator().manual_seed(0))
    direct = convert.init_params(cfg, torch.Generator().manual_seed(0))
    want = step(direct, optim.init(optcfg, direct), pumped)
    opt = optim.AdamWState(**shard_mod.place(
        optim.init(optcfg, base).tree(), host_mesh, o_sh.tree()))
    shard_mod.place(base, host_mesh, p_sh)
    got = step(base, opt, shard_mod.place(pumped, host_mesh, b_sh))
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(got[k], want[k]), k
    for (n, p), q in zip(base.named_parameters(), direct.parameters()):
        assert isinstance(p, DTensor)
        assert torch.equal(p.to_local(), q), n
    assert int(opt.step.to_local()) == 1


def test_mesh_factories(host_mesh):
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert mesh_mod.dp_degree(host_mesh) >= 1
    assert mesh_mod.mesh_axis_sizes(host_mesh) == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="needs a world of 256 ranks; "
                       "found a world of 1"):
        mesh_mod.make_production_mesh(device="cpu")


def test_production_meshes_on_fake_worlds():
    for multi_pod, n in ((False, 256), (True, 512)):
        with mesh_mod.fake_world(n):
            mesh = mesh_mod.make_production_mesh(multi_pod, device="cpu")
            assert mesh.size() == n
            assert mesh_mod.dp_degree(mesh) == n // 16
            with pytest.raises(RuntimeError, match=str(512 if not multi_pod
                                                       else 256)):
                mesh_mod.make_production_mesh(not multi_pod, device="cpu")
        assert not dist.is_initialized()


def test_placements_follow_mesh_order(fake22):
    assert shard_mod.placements(P(("data", "model"), None), fake22) == (
        Shard(0), Shard(0))
    assert shard_mod.placements(P(None, "model"), fake22) == (
        Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh's order"):
        shard_mod.placements(P(("model", "data")), fake22)


def test_constrain_and_batch_specs(fake22):
    x = torch.ones(4, 5)
    y = shard_mod.constrain(x, fake22, P("data", "model"))   # 5 % 2 != 0
    assert isinstance(y, DTensor) and y.placements == (Shard(0), Replicate())
    z = shard_mod.constrain(torch.ones(4, 6), fake22, P(None, "data"))
    assert z.placements == (Shard(1), Replicate())
    specs = shard_mod.batch_specs(
        {"tokens": torch.empty(4, 8, device="meta"),
         "odd": torch.empty(3, 8, device="meta"),
         "scalar": torch.empty((), device="meta"), "n": 3}, fake22)
    assert specs == {"tokens": P("data", None), "odd": P(None, None),
                     "scalar": P(),
                     "n": None}


# --------------------------------------- specs against the reference's --
def _ref_flat(tree, leaf_type):
    jax = pytest.importorskip("jax")
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, leaf_type))[0]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    jax = pytest.importorskip("jax")
    from jax.sharding import PartitionSpec
    from repro.configs.base import load_arch as jload
    from repro.launch import sharding as jshard
    from repro.launch import steps as jsteps
    jparams = jsteps.abstract_params(jload(arch))
    shapes = {k: v.shape for k, v in _ref_flat(jparams, type(None)).items()}
    params = steps_mod.abstract_params(load_arch(arch))
    for dims, names in MESHES:
        ref = _ref_flat(jshard.fit_specs(jshard.param_specs(jparams), jparams,
                                         StandIn(dims, names)), PartitionSpec)
        mine = shard_mod.fit_specs(shard_mod.param_specs(params), params,
                                   StandIn(dims, names))
        for name, spec in mine.items():
            key = "/".join(shard_mod.rule_names(name))
            want = tuple(ref[key])
            if len(shapes[key]) == len(spec) + 1:     # a stacked layer axis
                assert want[0] is None
                want = want[1:]
            assert tuple(spec) == want, (name, dims, spec, want)
        assert {"/".join(shard_mod.rule_names(n)) for n in mine} == set(ref)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch):
    jax = pytest.importorskip("jax")
    from jax.sharding import PartitionSpec
    from repro.configs.base import load_arch as jload
    from repro.launch import sharding as jshard
    from repro.launch import steps as jsteps
    shape = SHAPES["decode_32k"]
    jcache = jsteps.abstract_cache(jload(arch), shape)
    cache = steps_mod.abstract_cache(load_arch(arch), shape)
    for dims, names in MESHES:
        ref = _ref_flat(jshard.cache_specs(jcache, StandIn(dims, names)),
                        PartitionSpec)
        mine = shard_mod.cache_specs(cache, StandIn(dims, names))
        seen = set()

        def check(path, spec):
            if spec is None:                  # an int pos: no tensor
                assert path[-1] == "pos"
                return spec
            key = "/".join(k for k in path if not k.isdigit())
            want = tuple(ref[key])[1:]        # the stacked (L or G) axis
            assert tuple(spec) == want, (path, dims, spec, want)
            seen.add(key)
            return spec

        shard_mod.tree_map(check, mine)
        assert seen == {k for k in ref if not k.endswith("pos")}


def test_optimizer_state_widens_over_pod(monkeypatch):
    pytest.importorskip("jax")
    from repro import optim as joptim
    from repro.configs.base import load_arch as jload
    from repro.launch import sharding as jshard
    from repro.launch import steps as jsteps
    # NamedSharding needs a real 512-device mesh; keep its spec instead
    monkeypatch.setattr(jsteps, "NamedSharding", lambda m, s: s)
    monkeypatch.setattr(jshard, "NamedSharding", lambda m, s: s)
    for arch in ("qwen3-0.6b", "deepseek-v2-lite-16b"):
        (_, jo, _), _, (jparams, _, _) = jsteps.train_shardings(
            jload(arch), joptim.AdamWConfig(), StandIn(*MESHES[1]),
            jsteps.ShapeConfig("t", 4096, 256, "train"))
        ref = _ref_flat(jo.master, type(None))
        jshapes = {k: v.shape
                   for k, v in _ref_flat(jparams, type(None)).items()}
        params = steps_mod.abstract_params(load_arch(arch))
        mine = steps_mod.opt_specs(params, StandIn(*MESHES[1]))
        widened = 0
        for name, spec in mine.items():
            key = "/".join(shard_mod.rule_names(name))
            want = tuple(ref[key])
            if len(jshapes[key]) == len(spec) + 1:
                want = want[1:]
            assert tuple(spec) == want, (name, spec, want)
            widened += ("pod", "data") in tuple(spec)
        assert widened > 0
        plain = steps_mod.opt_specs(params, StandIn(*MESHES[0]))
        assert all("pod" not in str(s) for s in plain.values())


# ------------------------------------------ the serving steps against JAX --
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-1.3b"])
def test_serving_steps_match_reference(arch, host_mesh):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs.base import load_arch as jload
    from repro.launch import steps as jsteps
    from repro.models import model as jmodel
    jcfg, cfg = jload(arch, smoke=True), load_arch(arch, smoke=True)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    b, s, t = 2, 8, 16
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s))
    nxt = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, 1))
    jpre = jsteps.make_prefill_step(jcfg)(jparams,
                                          {"tokens": jnp.asarray(prompts)})
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    jcache = jmodel.init_cache(jcfg, b, t, jnp.float32)
    _, jcache = jdec(jparams, jcache, {"tokens": jnp.asarray(prompts)})
    jlog, _ = jdec(jparams, jcache, {"tokens": jnp.asarray(nxt)})

    model = convert.from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    direct = convert.from_jax_params(cfg, jax.tree.map(np.asarray, jparams))
    p_sh, c_sh, b_sh, _ = steps_mod.serve_shardings(
        cfg, host_mesh, ShapeConfig("d", t, b, "decode"))
    shard_mod.place(model, host_mesh, p_sh)
    cache = shard_mod.place(model_mod.init_cache(cfg, b, t, torch.float32),
                            host_mesh, c_sh)
    tok = {"tokens": torch.from_numpy(prompts)}
    pre = steps_mod.make_prefill_step(cfg)(model, tok)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), atol=1e-4)
    assert torch.equal(pre, model_mod.forward(cfg, direct, tok,
                                              last_only=True)[0])
    dec = steps_mod.make_decode_step(cfg)
    _, cache = dec(model, cache, shard_mod.place(tok, host_mesh, b_sh))
    logits, cache = dec(model, cache, shard_mod.place(
        {"tokens": torch.from_numpy(nxt)}, host_mesh, b_sh))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=1e-4)
    dcache = model_mod.init_cache(cfg, b, t, torch.float32)
    _, dcache = model_mod.decode_step(cfg, direct, tok, dcache)
    want, _ = model_mod.decode_step(cfg, direct,
                                    {"tokens": torch.from_numpy(nxt)}, dcache)
    assert torch.equal(logits, want)
    assert all(isinstance(t, DTensor) for t in shard_mod.leaves(cache))


# ---------------------------------------------------------------- dry run --
KEYS = {"arch", "shape", "mesh", "n_chips", "pump_factor", "kind", "wall_s",
        "flops", "argument_size_in_bytes", "collective_bytes",
        "collective_total", "collective_count"}


def test_dryrun_smoke_cells_on_a_fake_world():
    train = dryrun.run_cell("mamba2-1.3b", "train_4k", smoke=True,
                            mesh_shape=(2, 2))
    decode = dryrun.run_cell("qwen3-0.6b", "decode_32k", smoke=True,
                             mesh_shape=(2, 2))
    for cell in (train, decode):
        assert KEYS <= set(cell), KEYS - set(cell)
        assert cell["mesh"] == "2x2" and cell["n_chips"] == 4
        assert cell["flops"] > 0 and cell["argument_size_in_bytes"] > 0
    assert train["collective_count"] >= 1 and train["kind"] == "train"
    assert decode["kind"] == "decode"
    assert not dist.is_initialized()


def test_dryrun_main_fails_on_a_broken_cell(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL no-such-arch" in out and "0 cells OK, 1 failed" in out
    assert not dist.is_initialized()


def _cell_bytes(arch, shape_name, multi_pod):
    cfg = load_arch(arch)
    with mesh_mod.fake_world(512 if multi_pod else 256):
        mesh = dryrun.cell_mesh(multi_pod)
        _, args, trees = dryrun.cell_args(cfg, SHAPES[shape_name], mesh)
        experts = sum(p.to_local().numel() for n, p in
                      args[0].named_parameters()
                      if shard_mod.rule_names(n)[-2:] in
                      (["moe", "gate"], ["moe", "up"], ["moe", "down"]))
        return dryrun.local_bytes(*trees), experts


def test_full_width_argument_bytes_match_reference():
    """Per-device argument bytes at full width against the reference's dry
    run (jax 0.9.0, 512 fake host devices).  The reference's init draws the
    routed experts in bf16 and scales them by an fp32 factor, so they come
    out fp32 (reference ``models/moe.py:121-124``); the port keeps them in
    the param dtype, so an MoE cell differs by those experts' second half,
    counted here, and nothing else."""
    got, experts = _cell_bytes("qwen3-0.6b", "train_4k", False)
    assert experts == 0
    assert abs(got - 24_460_292) <= 0.01 * 24_460_292, got
    got, experts = _cell_bytes("deepseek-v2-lite-16b", "decode_32k", True)
    assert experts > 0
    assert abs(got + 2 * experts - 490_222_716) <= 0.01 * 490_222_716, got


# ------------------------------------------------------ launchers, meshes --
def test_launch_dispatcher_routes_tune_and_serve(monkeypatch):
    from repro_torch.launch import __main__ as dispatch
    from repro_torch.launch import serve, tune
    calls = []
    monkeypatch.setattr(serve, "main", lambda argv: calls.append(("serve",
                                                                  argv)))
    monkeypatch.setattr(tune, "main", lambda argv: calls.append(("tune",
                                                                 argv)))
    dispatch.main(["serve", "--arch", "x"])
    dispatch.main(["tune", "--smoke"])
    assert calls == [("serve", ["--arch", "x"]), ("tune", ["--smoke"])]
    for argv in ([], ["train"], ["dryrun"], ["--help"]):
        with pytest.raises(SystemExit, match="usage"):
            dispatch.main(argv)


def test_kernel_launch_refuses_a_dtensor(monkeypatch, host_mesh):
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import InputError
    monkeypatch.setattr(ops, "_route", lambda x, name: True)
    q = torch.randn(1, 2, 8, 16)
    dq = shard_mod.place({"q": q}, host_mesh, {"q": P()})["q"]
    with pytest.raises(InputError, match="flash_attention: operand.*DTensor"):
        ops.flash_attention(dq, q, q, causal=True)
    with pytest.raises(InputError, match="decode_attention: .*DTensor"):
        ops.decode_attention(q[:, :, 0], dq, q, 4)


def test_engine_on_host_mesh_serves_the_direct_route(host_mesh):
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = dataclasses.replace(load_arch("qwen3-0.6b", smoke=True),
                              attention_impl="pallas")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(1))
    outs = []
    for mesh in (None, host_mesh):
        model = convert.init_params(cfg, torch.Generator().manual_seed(0))
        eng = Engine(cfg, model, ServeConfig(batch=2, max_len=17),
                     device="cpu", mesh=mesh)
        outs.append(eng.generate(prompts, 8, return_logits=True))
    assert isinstance(next(eng.model.parameters()), DTensor)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_engine_refuses_a_sharded_mesh(fake22):
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = load_arch("qwen3-0.6b", smoke=True)
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="shards"):
        Engine(cfg, model, ServeConfig(batch=2, max_len=17), device="cpu",
               mesh=fake22)


def test_train_on_host_mesh_is_the_direct_run(host_mesh, tmp_path):
    from repro_torch.train.trainer import TrainConfig, train
    cfg = load_arch("qwen3-0.6b", smoke=True)
    shape = ShapeConfig("t", 16, 4, "train")
    optcfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    runs = []
    for mesh in (None, host_mesh):
        runs.append(train(cfg, shape, optcfg,
                          TrainConfig(n_steps=3, pump_factor=2, log_every=1,
                                      ckpt_root=str(tmp_path / str(mesh
                                                                   is None)),
                                      ckpt_every=2),
                          device="cpu", mesh=mesh, log=lambda *a: None))
    assert [h["loss"] for h in runs[0]["history"]] == \
        [h["loss"] for h in runs[1]["history"]]
    state = runs[1]["final_state"]
    assert isinstance(state.opt_state.master["embed.embedding"], DTensor)
    assert int(state.opt_state.step.to_local()) == 3
    # resumed under the mesh from its own checkpoint: the same state
    more = train(cfg, shape, optcfg,
                 TrainConfig(n_steps=4, pump_factor=2, log_every=1,
                             ckpt_root=str(tmp_path / "False")),
                 device="cpu", mesh=host_mesh, log=lambda *a: None)
    assert more["history"][0]["step"] == 4


def test_no_mesh_makes_no_process_group():
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train.trainer import TrainConfig, train
    assert not dist.is_initialized()
    cfg = load_arch("qwen3-0.6b", smoke=True)
    model = convert.init_params(cfg, torch.Generator().manual_seed(0))
    Engine(cfg, model, ServeConfig(batch=1, max_len=8),
           device="cpu").generate(torch.zeros(1, 4, dtype=torch.long), 2)
    train(cfg, ShapeConfig("t", 8, 2, "train"), optim.AdamWConfig(),
          TrainConfig(n_steps=1), device="cpu", log=lambda *a: None)
    assert not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launch_train_refuses_production_mesh_at_world_one():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), WORLD_SIZE="1",
               RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps", "1",
         "--production-mesh"], env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "needs a world of 256 ranks; found a world of 1" in proc.stderr


def test_failover_drill_example_runs_on_cpu():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_failover_drill
    finally:
        sys.path.remove(str(ROOT / "examples"))
    out = torch_failover_drill.main(["--device", "cpu"])
    assert out == {"remesh_ok": True, "sharded": out["sharded"], "dp": 2}
    assert out["sharded"] > 0 and not dist.is_initialized()
