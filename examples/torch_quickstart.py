"""Quickstart for the PyTorch port: temporal vectorization end to end.

1. Build a dataflow graph, stream it, multi-pump it, and watch the
   resource / throughput numbers move as in the paper.
2. Run the hand-written matmul and Floyd-Warshall kernels (on the card;
   their plain PyTorch versions on the CPU) in both modes.
3. Train a tiny LM with the trainer's pump (a microbatched gradient
   stream), then one more run under the host mesh.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import optim
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.autopump import autopump
from repro_torch.core.executor import run as execute
from repro_torch.core.ir import AccessPattern, Domain, Graph, PumpSpec
from repro_torch.core.multipump import apply_multipump, throughput_model
from repro_torch.core.streaming import apply_streaming
from repro_torch.core.symbolic import Affine
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train.trainer import TrainConfig, train


def section(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    section("1. The compiler view: stream, then multi-pump")
    n, v = 64, 4
    g = Graph("vecadd")
    g.memory("x", (n,))
    g.memory("y", (n,))
    g.memory("z", (n,))
    dom = Domain.of(("i", 0, n // v))
    acc = AccessPattern(dom, (Affine.of("i", v),), width=v)
    g.compute("add", dom, fn=lambda in0, in1: {"out0": in0 + in1},
              vector_width=v)
    g.connect("x", "add", acc)
    g.connect("y", "add", acc)
    g.connect("add", "z", acc)
    streamed, report = apply_streaming(g)
    print("streaming pass:", report.streamed)
    for mode in ("T", "R"):
        pumped, rep = apply_multipump(streamed, factor=2, mode=mode)
        r0, r1 = rep.resources_before, rep.resources_after
        print(f"mode {mode}: compute units {r0['compute_units']} -> "
              f"{r1['compute_units']}, throughput "
              f"{throughput_model(streamed):.0f} -> "
              f"{throughput_model(pumped):.0f} elems/cycle")
        x = np.arange(n, dtype=np.float32)
        assert np.allclose(execute(pumped, {"x": x, "y": 2 * x})["z"], 3 * x)
    print("value preservation: OK")

    section(f"2. The kernel view: pumped kernels on {dev}")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(128, 128, generator=gen, device=dev)
    b = torch.randn(128, 128, generator=gen, device=dev)
    gold = a @ b
    for pump in (PumpSpec(1), PumpSpec(2, "T"), PumpSpec(2, "R")):
        err = float((ops.matmul(a, b, pump=pump) - gold).abs().max())
        print(f"matmul pump={pump.factor} mode={pump.mode}: max err "
              f"{err:.1e}")
    plan = autopump("floyd_warshall", 64)
    print(f"autopump(floyd_warshall): {plan.summary()}")
    d = torch.rand(64, 64, generator=gen, device=dev) * 10 + 0.1
    assert torch.equal(ops.floyd_warshall(d, pump=1),
                       ops.floyd_warshall(d, pump=plan.spec.factor))
    print("floyd-warshall pumped == original: dependencies preserved")

    section("3. The trainer's pump, then the host mesh")
    cfg = ModelConfig("quickstart-lm", "dense", 2, 64, 4, 2, 128, 128,
                      dtype="float32")
    shape = ShapeConfig("qs", 64, 8, "train")
    optcfg = optim.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    out = train(cfg, shape, optcfg,
                TrainConfig(n_steps=30, pump_factor=4, log_every=10),
                device=dev)
    print(f"trained with pump=4: loss {out['history'][0]['loss']:.3f} -> "
          f"{out['history'][-1]['loss']:.3f}")
    mesh = mesh_mod.make_host_mesh(dev)
    try:
        meshed = train(cfg, shape, optcfg,
                       TrainConfig(n_steps=30, pump_factor=4, log_every=10),
                       device=dev, mesh=mesh)
    finally:
        mesh_mod.destroy_group()
    same = meshed["history"][-1]["loss"] == out["history"][-1]["loss"]
    print(f"under the host mesh {mesh_mod.mesh_axis_sizes(mesh)}: loss "
          f"{meshed['history'][-1]['loss']:.3f} (bit-equal: {same})")
    print("\nquickstart complete.")
    return out


if __name__ == "__main__":
    main()
