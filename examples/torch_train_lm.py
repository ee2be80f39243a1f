"""Train a qwen3-family LM with the pumped gradient stream, checkpoints
and failure recovery, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--dim 512]

The default config has about 4M parameters, so a few hundred steps take
minutes on the CPU; ``--dim 768 --layers 12`` is the ~100M run (the same
path).  ``--host-mesh`` trains under the host mesh (the world on one
process, every placement replicated).
"""
import argparse
import shutil
import tempfile

from repro_torch import device as device_mod
from repro_torch import optim
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train.trainer import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pump", default="2")
    ap.add_argument("--host-mesh", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    cfg = ModelConfig(
        name="example-lm", family="dense",
        n_layers=args.layers, d_model=args.dim,
        n_heads=max(4, args.dim // 64), n_kv_heads=max(2, args.dim // 128),
        d_ff=args.dim * 4, vocab_size=8192, qk_norm=True,
        tie_embeddings=True, dtype="float32")
    print(f"[example] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    shape = ShapeConfig("ex", args.seq, args.batch, "train")
    ckpt_root = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    pump = args.pump if args.pump == "auto" else int(args.pump)
    mesh = mesh_mod.make_host_mesh(dev) if args.host_mesh else None
    try:
        out = train(
            cfg, shape,
            optim.AdamWConfig(lr=1e-3, warmup_steps=max(args.steps // 10, 1),
                              total_steps=args.steps),
            TrainConfig(n_steps=args.steps, pump_factor=pump,
                        ckpt_root=ckpt_root, ckpt_every=100,
                        log_every=max(args.steps // 10, 1)),
            device=dev, mesh=mesh)
    finally:
        mesh_mod.destroy_group()
        shutil.rmtree(ckpt_root, ignore_errors=True)
    h = out["history"]
    print(f"[example] loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} "
          f"(pump={out['pump']})")
    return out


if __name__ == "__main__":
    main()
