"""Serve small models with batched requests through the port's Engine:
prefill, then one decode step a token, for the dense GQA, MLA + MoE, SSM
and hybrid families (SMOKE configs, seeded weights), on the card unless
``--device cpu``; the dense model once more through the host mesh.

    PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse
import dataclasses
import time

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import load_arch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import convert
from repro_torch.serve.engine import Engine, ServeConfig


def demo(arch, dev, batch=2, prompt=8, new=8, mesh=None):
    cfg = load_arch(arch, smoke=True)
    if dev.type == "cuda":
        # the hand-written kernels on the card
        cfg = dataclasses.replace(cfg, attention_impl="pallas",
                                  ssm_impl="pallas")
    model = convert.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(cfg, model,
                 ServeConfig(batch=batch, max_len=prompt + new + 1),
                 device=dev, mesh=mesh)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=torch.Generator().manual_seed(1))
    t0 = time.time()
    out = eng.generate(prompts, new)
    dt = time.time() - t0
    where = " (host mesh)" if mesh is not None else ""
    print(f"[serve] {arch:24s} generated {tuple(out.shape)} in {dt:5.2f}s "
          f"({batch * new / dt:7.1f} tok/s)  first: {out[0][:6].tolist()}"
          f"{where}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    outs = {arch: demo(arch, dev) for arch in
            ("qwen3-0.6b", "deepseek-v2-lite-16b", "mamba2-1.3b",
             "zamba2-2.7b")}
    mesh = mesh_mod.make_host_mesh(dev)
    try:
        meshed = demo("qwen3-0.6b", dev, mesh=mesh)
    finally:
        mesh_mod.destroy_group()
    assert torch.equal(meshed, outs["qwen3-0.6b"])
    print("[serve] all families served; the host mesh's tokens equal the "
          "direct route's.")
    return outs


if __name__ == "__main__":
    main()
