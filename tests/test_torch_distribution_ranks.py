"""Two real ranks on gloo: the sharded train step and the resharded
restore (the port of the reference's ``tests/test_system.py::
test_elastic_remesh``, across meshes of two ranks).

Two CPU processes join one process group on a ``FileStore`` under
``tmp_path`` and run :func:`worker` (this file, run as a script).  Each
builds qwen3's SMOKE model from the same seed and runs one train step
unsharded, then the same step with the model, the optimizer state and the
batch placed under ``train_shardings`` on a (2, 1) mesh (FSDP over
"data") and on a (1, 2) mesh (TP over "model"): loss and grad norm within
1e-5 relative, every parameter within 5e-6 of the unsharded step's; the
same loss and grad norm bounds for mamba2's and deepseek-v2-lite's SMOKE
step (the scan per batch row, the MoE layer whole); a cached prefill and
one decode step on a placed cache within 1e-5 of the direct path's
logits.  Then a state placed on (2, 1) is saved (gathered whole, rank 0
writes) and restored by ``elastic_remesh`` onto (1, 2): the full tensors
equal the saved ones bit for bit.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
JOIN_S = 120


def worker(rank: int, store: str, out: str, ckpt_root: str) -> None:
    import copy

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import optim
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs.base import ShapeConfig, load_arch
    from repro_torch.launch import sharding as shard_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import convert, model as model_mod
    from repro_torch.runtime import failover

    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    torch.manual_seed(0)
    cfg = load_arch("qwen3-0.6b", smoke=True)
    shape = ShapeConfig("t", 16, 4, "train")
    # eps 1: the first AdamW update is about lr * g, linear in the
    # gradient; at the default 1e-8 an element whose gradient is near 0
    # moves by up to lr on either side of a rounding difference in it
    optcfg = optim.AdamWConfig(lr=1e-2, eps=1.0, warmup_steps=1,
                               total_steps=10)
    base = convert.init_params(cfg, torch.Generator().manual_seed(0))
    batch = model_mod.example_batch(cfg, shape)
    step = steps_mod.make_train_step(cfg, optcfg)

    ref_model = copy.deepcopy(base)
    ref = step(ref_model, optim.init(optcfg, ref_model), batch)
    ref_params = {n: p.detach().clone()
                  for n, p in ref_model.named_parameters()}

    def placed(mesh):
        (p_sh, o_sh, b_sh), _, _ = steps_mod.train_shardings(
            cfg, optcfg, mesh, shape, torch.float32)
        model = copy.deepcopy(base)
        opt = optim.init(optcfg, model)
        shard_mod.place(model, mesh, p_sh)
        opt = optim.AdamWState(**shard_mod.place(
            opt.tree(), mesh, o_sh.tree()))
        return model, opt, shard_mod.place(batch, mesh, b_sh)

    result = {"rank": rank, "meshes": {}, "families": {}, "serve": {}}
    meshes = {dims: init_device_mesh("cpu", dims,
                                     mesh_dim_names=("data", "model"))
              for dims in ((2, 1), (1, 2))}
    for dims, mesh in meshes.items():
        model, opt, b = placed(mesh)
        metrics = step(model, opt, b)
        err = max(float((p.full_tensor() - ref_params[n]).abs().max())
                  for n, p in model.named_parameters())
        sharded = sum(not shard_mod.replicated({"p": p})
                      for p in model.parameters())
        result["meshes"]["x".join(map(str, dims))] = {
            "loss": float(metrics["loss"]), "ref_loss": float(ref["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "ref_grad_norm": float(ref["grad_norm"]),
            "param_err": err, "sharded_params": sharded}

    # the other families' redistribution points (the SSD scan per batch
    # row, the MoE layer whole): one sharded step's loss and grad norm
    for arch in ("mamba2-1.3b", "deepseek-v2-lite-16b"):
        fcfg = load_arch(arch, smoke=True)
        fbatch = model_mod.example_batch(fcfg, shape)
        fstep = steps_mod.make_train_step(fcfg, optcfg)
        fbase = convert.init_params(fcfg, torch.Generator().manual_seed(0))
        fref = copy.deepcopy(fbase)
        want = fstep(fref, optim.init(optcfg, fref), fbatch)
        for dims, mesh in meshes.items():
            (p_sh, o_sh, b_sh), _, _ = steps_mod.train_shardings(
                fcfg, optcfg, mesh, shape, torch.float32)
            fm = copy.deepcopy(fbase)
            fo = optim.init(optcfg, fm)
            shard_mod.place(fm, mesh, p_sh)
            fo = optim.AdamWState(**shard_mod.place(fo.tree(), mesh,
                                                    o_sh.tree()))
            got = fstep(fm, fo, shard_mod.place(fbatch, mesh, b_sh))
            result["families"][f"{arch} {dims}"] = {
                k: (float(got[k]), float(want[k]))
                for k in ("loss", "grad_norm")}

    # serving: a cached prefill and a decode step on a placed cache
    tokens = batch["tokens"][:, :8]
    nxt = batch["tokens"][:, 8:9]
    dmodel = copy.deepcopy(base)
    dcache = model_mod.init_cache(cfg, 4, 16, torch.float32)
    _, dcache = model_mod.decode_step(cfg, dmodel, {"tokens": tokens},
                                      dcache)
    want, _ = model_mod.decode_step(cfg, dmodel, {"tokens": nxt}, dcache)
    for dims, mesh in meshes.items():
        p_sh, c_sh, b_sh, _ = steps_mod.serve_shardings(
            cfg, mesh, ShapeConfig("d", 16, 4, "decode"), torch.float32)
        smodel = copy.deepcopy(base)
        shard_mod.place(smodel, mesh, p_sh)
        cache = shard_mod.place(model_mod.init_cache(cfg, 4, 16,
                                                     torch.float32),
                                mesh, c_sh)
        dec = steps_mod.make_decode_step(cfg)
        _, cache = dec(smodel, cache, shard_mod.place(
            {"tokens": tokens}, mesh, b_sh))
        got, cache = dec(smodel, cache, shard_mod.place(
            {"tokens": nxt}, mesh, b_sh))
        result["serve"]["x".join(map(str, dims))] = float(
            (got.full_tensor() - want).abs().max())

    # save under (2, 1), restore onto (1, 2)
    mesh_a, mesh_b = meshes[(2, 1)], meshes[(1, 2)]
    model, _, _ = placed(mesh_a)
    like = dict(model.named_parameters())
    saved = {n: p.detach().full_tensor() for n, p in like.items()}
    ckpt.save(ckpt_root, 3, like, extra={"step": 3})
    back, extra = failover.elastic_remesh(
        ckpt.latest_valid(ckpt_root), like, mesh_b,
        lambda t, m: shard_mod.shardings(t, m))
    result["restore"] = {
        "step": extra["step"],
        "bit_exact": all(torch.equal(back[n].full_tensor(), saved[n])
                         for n in saved),
        "placements_b": sorted({str(back[n].placements) for n in back}),
        "sharded_b": sum(not shard_mod.replicated({"p": t})
                         for t in back.values())}
    dist.barrier()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)


def test_two_ranks_sharded_step_and_resharded_restore(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.json") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), store, outs[r],
         str(tmp_path / "ckpt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    deadline = time.monotonic() + JOIN_S
    logs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            out, _ = p.communicate(timeout=left)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    for path in outs:
        res = json.load(open(path))
        for dims, m in res["meshes"].items():
            assert m["sharded_params"] > 0, dims
            assert abs(m["loss"] - m["ref_loss"]) <= 1e-5 * abs(m["ref_loss"])
            assert abs(m["grad_norm"] - m["ref_grad_norm"]) \
                <= 1e-5 * abs(m["ref_grad_norm"])
            assert m["param_err"] <= 5e-6, (dims, m["param_err"])
        for key, vals in res["families"].items():
            for name, (got, want) in vals.items():
                assert abs(got - want) <= 1e-5 * abs(want), (key, name)
        for dims, e in res["serve"].items():
            assert e <= 1e-5, (dims, e)
        r = res["restore"]
        assert r["step"] == 3 and r["bit_exact"] and r["sharded_b"] > 0


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
