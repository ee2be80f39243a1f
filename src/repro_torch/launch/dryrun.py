"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step once,
on a fake world of 256 or 512 ranks, as rank 0.  The port of
``repro.launch.dryrun``.

For each cell the driver makes a fake world (``launch.mesh.fake_world``:
torch's fake process group, whose collectives move nothing), builds the
production mesh, builds the step's abstract arguments on ``meta`` (no
memory, no draw) and places them under the rules as DTensors
(``launch.steps``: ``train_shardings`` / ``serve_shardings``), then runs
the step once on the config's default (plain) routes and records:

  - ``flops``: the FLOPs of this rank's local ops, by the formulas of
    ``torch.utils.flop_counter`` (``FlopCounterMode``'s), counted below
    DTensor so that a sharded product counts its shard;
  - ``argument_size_in_bytes``: the bytes of this rank's shards of the
    step's arguments (params, optimizer state, batch, cache), which says
    whether the config fits the card's memory;
  - ``collective_count``, ``collective_counts`` and ``collective_bytes``:
    the collectives DTensor issued, by kind under the reference's names
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), counted by
    ``torch.distributed.tensor.debug.CommDebugMode``, with the bytes of
    each one's output;
  - ``wall_s`` (the reference's ``compile_s``: the port compiles nothing).

The reference's XLA-only keys (``temp_size_in_bytes``,
``generated_code_size_in_bytes``, ``bytes_accessed``) have no counterpart
here and are left out: an eager step has no compiled module whose
temporaries or code size could be read.  The collectives and FLOPs come
from another partitioner (DTensor's sharding propagation, not XLA's SPMD
pass) and another counter, so they differ from the reference's; the
argument bytes follow from the rules and the shapes alone, so they should
not.  A cell that fails prints its reason and counts as failed; ``main``
exits 1 if any did.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import optim
from repro_torch.configs.base import SHAPES, ShapeConfig, cells, load_arch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import sharding as shard_mod
from repro_torch.launch import steps as steps_mod

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# torch's functional collectives (what DTensor issues) by the reference's
# HLO names
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "permute_tensor": "collective-permute"}


class _LocalCounter(TorchDispatchMode):
    """Counts, below DTensor, the ops this rank runs on its local tensors:
    the FLOPs of each (``torch.utils.flop_counter``'s formulas, those of
    ``FlopCounterMode``) and the output bytes of every functional
    collective by kind.  An op on DTensors is handed back
    (``NotImplemented``) so DTensor desugars it into local ops and
    collectives first, as ``CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes: Dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out        # DTensor's shape inference, not a rank's op
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if "c10d_functional" in getattr(func, "namespace", ""):
            kind = _KINDS.get(func._opname)
            if kind is not None:
                for t in out if isinstance(out, (list, tuple)) else (out,):
                    if isinstance(t, torch.Tensor):
                        self.bytes[kind] += t.numel() * t.element_size()
        return out


class CollectiveTally:
    """``with CollectiveTally() as tally:`` counts the collectives a
    DTensor program issues (``CommDebugMode``), the bytes of their
    outputs and the FLOPs of this rank's local ops (``_LocalCounter``);
    ``tally.result()`` gives ``count``, ``counts`` and ``bytes`` by kind
    under the reference's names, and ``flops``."""

    def __enter__(self):
        from torch.distributed.tensor.debug import CommDebugMode
        self._comm = CommDebugMode()
        self._local = _LocalCounter()
        self._comm.__enter__()
        self._local.__enter__()
        return self

    def __exit__(self, *exc):
        self._local.__exit__(*exc)
        self._comm.__exit__(*exc)
        return False

    def result(self) -> Dict[str, Any]:
        counts = {k: 0 for k in COLLECTIVE_OPS}
        for op, n in self._comm.get_comm_counts().items():
            kind = _KINDS.get(op.__name__.split(".")[-1])
            if kind is not None:
                counts[kind] += n
        return {"count": sum(counts.values()), "counts": counts,
                "bytes": dict(self._local.bytes),
                "flops": self._local.flops}


def local_bytes(*trees) -> int:
    """The bytes of this rank's shards of every tensor in ``trees``."""
    total = 0
    for tree in trees:
        for t in shard_mod.leaves(tree):
            local = t.to_local() if isinstance(t, DTensor) else t
            total += local.numel() * local.element_size()
    return total


def cell_args(cfg, shape: ShapeConfig, mesh, pump_factor: int = 1,
              param_dtype=torch.bfloat16):
    """The cell's step and its abstract arguments placed under the rules:
    ``(step, args, trees)``, ``trees`` the argument trees whose shards are
    ``argument_size_in_bytes`` (params, optimizer state, batch, cache)."""
    optcfg = optim.AdamWConfig(moment_dtype="bfloat16")
    if shape.kind == "train":
        step = steps_mod.make_train_step(cfg, optcfg, pump_factor)
        in_sh, _out, (params, opt, batch) = steps_mod.train_shardings(
            cfg, optcfg, mesh, shape, param_dtype, pump_factor)
        shard_mod.place(params, mesh, in_sh[0])
        opt = optim.AdamWState(**shard_mod.place(
            opt.tree(), mesh, in_sh[1].tree()))
        args = (params, opt, shard_mod.place(batch, mesh, in_sh[2]))
        return step, args, (params, opt.tree(), args[2])
    if shape.kind == "prefill":
        step = steps_mod.make_prefill_step(cfg)
        params = steps_mod.abstract_params(cfg, param_dtype)
        shard_mod.place(params, mesh, shard_mod.shardings(params, mesh))
        batch = steps_mod.abstract_batch(cfg, shape)
        del batch["labels"]
        batch = shard_mod.place(batch, mesh,
                                steps_mod.train_batch_specs(batch, mesh))
        return step, (params, batch), (params, batch)
    step = steps_mod.make_decode_step(cfg)
    p_sh, c_sh, b_sh, (params, cache, batch) = steps_mod.serve_shardings(
        cfg, mesh, shape, param_dtype)
    shard_mod.place(params, mesh, p_sh)
    args = (params, shard_mod.place(cache, mesh, c_sh),
            shard_mod.place(batch, mesh, b_sh))
    return step, args, args


def _run_step(cfg, shape: ShapeConfig, mesh, pump_factor: int, param_dtype):
    """Builds, places and runs the cell's step once: its argument bytes,
    the tally (collectives and FLOPs) and the step's wall time."""
    step, args, trees = cell_args(cfg, shape, mesh, pump_factor, param_dtype)
    arg_bytes = local_bytes(*trees)
    t0 = time.perf_counter()
    with CollectiveTally() as tally:
        step(*args)
    return arg_bytes, tally.result(), time.perf_counter() - t0


def cell_mesh(multi_pod: bool = False,
              mesh_shape: Optional[Sequence[int]] = None):
    """The cell's mesh in the current (fake) world: the production mesh,
    or ``mesh_shape`` ((data, model) or (pod, data, model)), a smaller
    stand-in for tests."""
    if mesh_shape is None:
        return mesh_mod.make_production_mesh(multi_pod, device="cpu")
    from torch.distributed.device_mesh import init_device_mesh
    dims = tuple(mesh_shape)
    names = ("pod", "data", "model")[-len(dims):]
    return init_device_mesh("cpu", dims, mesh_dim_names=names)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             pump_factor: int = 1, param_dtype=torch.bfloat16,
             smoke: bool = False, mesh_shape: Optional[Sequence[int]] = None,
             verbose: bool = True) -> Dict[str, Any]:
    """One cell on a fake world of the production mesh's size (or of
    ``mesh_shape``, a smaller stand-in for tests: (data, model) or (pod,
    data, model)), as rank 0; the world is destroyed after the cell.
    ``smoke`` takes the SMOKE config (and shapes cut to its size)."""
    cfg = load_arch(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    if smoke:
        shape = ShapeConfig(shape.name, 32, 4, shape.kind)
    dims = tuple(mesh_shape) if mesh_shape is not None \
        else mesh_mod.production_shape(multi_pod)[0]
    n_chips = math.prod(dims)
    t0 = time.perf_counter()
    with mesh_mod.fake_world(n_chips):
        mesh = cell_mesh(multi_pod, mesh_shape)
        arg_bytes, coll, step_s = _run_step(cfg, shape, mesh,
                                                   pump_factor, param_dtype)
    wall = time.perf_counter() - t0
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, dims)),
        "n_chips": n_chips,
        "pump_factor": pump_factor,
        "kind": shape.kind,
        "wall_s": round(wall, 3),
        "step_s": round(step_s, 3),
        "flops": float(coll["flops"]),
        "argument_size_in_bytes": int(arg_bytes),
        "collective_bytes": {k: v for k, v in coll["bytes"].items() if v},
        "collective_total": sum(coll["bytes"].values()),
        "collective_count": coll["count"],
        "collective_counts": {k: v for k, v in coll["counts"].items() if v},
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {result['mesh']} "
              f"OK in {result['wall_s']}s  flops={result['flops']:.3e}  "
              f"args={result['argument_size_in_bytes']}B/device  "
              f"coll={result['collective_total']:.3e}B "
              f"({result['collective_count']} ops)")
        sys.stdout.flush()
    return result


def _where(e: BaseException) -> str:
    """The innermost frame of the port in ``e``'s traceback."""
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename]
    if not frames:
        return "?"
    f = frames[-1]
    return f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--pump", type=int, default=1)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    results = []
    if args.all:
        todo = cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in todo:
        for mp in meshes:
            try:
                results.append(run_cell(arch, shape, multi_pod=mp,
                                        pump_factor=args.pump))
            except Exception as e:  # noqa: BLE001 — report and continue
                mesh_mod.destroy_group()
                failures.append((arch, shape, mp, repr(e)[:300]))
                print(f"[dryrun] FAIL {arch} × {shape} × "
                      f"{'2x16x16' if mp else '16x16'} at {_where(e)}: "
                      f"{e!r}"[:600])
                sys.stdout.flush()

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(f"\n[dryrun] {len(results)} cells OK, {len(failures)} failed")
    if failures:
        for f in failures:
            print("  FAIL:", f)
        sys.exit(1)


if __name__ == "__main__":
    main()
