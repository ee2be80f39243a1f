"""Fault-tolerance drill on the port: kill training mid-run, resume from
the checkpoint, then elastically re-mesh the checkpoint onto a mesh of
another data-parallel degree.

    PYTHONPATH=src python examples/torch_failover_drill.py [--device cpu]

The drill trains on the card unless ``--device cpu``.  Its last part
saves the state placed on the (1, 1) host mesh and restores it with
``elastic_remesh`` onto a (2, 1) mesh in a fake world of two ranks (no
second card is needed: the restore places the tensors, and rank 0's
shards are checked against the saved tensors' halves).
"""
import argparse
import copy
import shutil
import tempfile

import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import device as device_mod
from repro_torch import optim
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import DataIterator
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding as shard_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models import convert
from repro_torch.runtime import failover

CFG = ModelConfig("drill", "dense", 2, 64, 4, 2, 128, 128, dtype="float32")
SHAPE = ShapeConfig("d", 64, 8, "train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    root = tempfile.mkdtemp(prefix="repro_torch_drill_")
    optcfg = optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = convert.init_params(CFG, gen, dev).requires_grad_(True)
    init = {"params": copy.deepcopy(model.state_dict()),
            "opt": optim.init(optcfg, model).tree()}
    step_fn = steps_mod.make_train_step(CFG, optcfg)
    data = DataIterator(CFG, SHAPE, device=dev)
    fail_once = {"armed": True}

    def load(tree):
        with torch.no_grad():
            model.load_state_dict(tree["params"])
        return optim.AdamWState(**{k: tree["opt"][k]
                                   for k in ("step", "master", "m", "v")})

    def train_fn(state, step):
        if step == 13 and fail_once["armed"]:
            fail_once["armed"] = False
            print(f"[drill] >>> injecting node failure at step {step} <<<")
            raise failover.FailureInjected("simulated node loss")
        opt = load(state)
        data.step = step          # exactly-once batches
        m = step_fn(model, opt, next(data))
        if step % 10 == 0:
            print(f"[drill] step {step:3d} loss {float(m['loss']):.4f}")
        return {"params": model.state_dict(), "opt": opt.tree()}

    try:
        final = failover.run_with_recovery(
            train_fn, init, n_steps=25, ckpt_root=root + "/ckpt",
            ckpt_every=5,
            tree_to_state=lambda t, like: {
                "params": {k: v.to(dev) for k, v in t["params"].items()},
                "opt": {k: (v.to(dev) if isinstance(v, torch.Tensor)
                            else {n: x.to(dev) for n, x in v.items()})
                        for k, v in t["opt"].items()}})
        print("[drill] survived the failure; 25 effective steps completed")

        # --- elastic re-mesh: save on (1, 1), restore onto (2, 1) --------
        params = {k: v.detach().cpu() for k, v in final["params"].items()}
        one = mesh_mod.make_host_mesh("cpu")
        try:
            placed = shard_mod.place(params, one,
                                     shard_mod.shardings(params, one))
            path = ckpt.save(root + "/remesh", 25, placed,
                             extra={"step": 25})
        finally:
            mesh_mod.destroy_group()
        with mesh_mod.fake_world(2):
            two = init_device_mesh("cpu", (2, 1),
                                   mesh_dim_names=("data", "model"))
            back, extra = failover.elastic_remesh(
                path, params, two, lambda t, m: shard_mod.shardings(t, m))
            dp = mesh_mod.dp_degree(two)
            ok = all(torch.equal(
                back[n].to_local(),
                params[n].chunk(dp, dim=back[n].placements[0].dim)[0]
                if back[n].placements[0].is_shard() else params[n])
                for n in params)
            sharded = sum(not shard_mod.replicated({"t": t})
                          for t in back.values())
        n = sum(t.numel() for t in params.values())
        print(f"[drill] elastically re-meshed checkpoint (step "
              f"{extra['step']}, {n / 1e3:.0f}K params) from data-parallel "
              f"degree 1 onto {dp} ({sharded} tensors sharded); rank 0's "
              f"shards equal the saved tensors: {ok}")
        assert ok and sharded > 0
        pol = failover.StragglerPolicy(base_pump=8)
        for w, t in [(0, 1.0), (1, 1.05), (2, 3.2)]:
            for _ in range(10):
                pol.observe(w, t)
        print(f"[drill] straggler-aware pump factors: {pol.pump_factors()} "
              "(slow host derated, sync schedule preserved)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"remesh_ok": ok, "sharded": sharded, "dp": dp}


if __name__ == "__main__":
    main()
