"""Atomic, content-verified checkpoints: the port of
``repro.checkpoint.manager``, with the reference's layout:

    <root>/step_00000042/
        manifest.json      # leaf names, shapes, dtypes, shard hashes
        shard_00000.npz    # the leaves (leaf_00000, leaf_00001, ...)
    <root>/LATEST          # pointer, renamed into place last

- two-phase commit: the step is written to ``<dir>.tmp`` and
  ``os.rename``d into place, then ``LATEST`` is written to ``LATEST.tmp``
  and renamed, so a crash mid-write never corrupts the restore path;
- every shard's sha256 is in the manifest; ``latest_valid`` verifies
  before trusting a checkpoint and falls back to an older one;
- the trainer saves the data stream's step beside the state
  (``extra``), giving exactly-once batches across restarts.

A state is a tree of dicts whose leaves are tensors.  A leaf's name is its
dict keys joined by ``/`` (a module's ``state_dict`` names hold dots, so
the trainer's leaves read ``params/blocks.0.attn.wq.w`` and
``opt_state/master/blocks.0.attn.wq.w``).  numpy has no bf16, so a bf16
leaf is stored as its raw 16 bits (uint16) with ``bfloat16`` as its dtype
in the manifest: a round trip is bit-exact for every dtype.

A state placed on a mesh (DTensor leaves, ``launch.sharding``) is saved
whole: each DTensor is gathered (``full_tensor``, a collective every rank
joins) and rank 0 writes.  ``restore_resharded`` restores through
``restore`` (bit-exact) and places the tensors under a mesh's
placements, which may be another mesh than the one the checkpoint was
saved from (``runtime.failover.elastic_remesh``).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

SEP = "/"


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if SEP in key:
            raise ValueError(f"checkpoint key {key!r} holds {SEP!r}")
        name = prefix + key
        if isinstance(val, dict):
            out.update(_flatten(val, name + SEP))
        else:
            out[name] = val
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, val in flat.items():
        node = tree
        *path, leaf = name.split(SEP)
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """The leaf as numpy; bf16 (which numpy lacks) as its raw bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    if dtype == "bfloat16":
        return t.view(torch.int16).view(torch.bfloat16)
    return t


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def save(root: str, step: int, state: Dict[str, Any],
         extra: Optional[dict] = None) -> str:
    """Two-phase atomic save of ``state`` (a tree of dicts of tensors).
    DTensor leaves are gathered whole and only rank 0 writes; every rank
    must call it then, and all return once the checkpoint is in place."""
    final = os.path.join(root, f"step_{step:08d}")
    flat = _flatten(state)
    placed = any(isinstance(v, DTensor) for v in flat.values())
    leaves = [v.full_tensor() if isinstance(v, DTensor) else torch.as_tensor(v)
              for v in flat.values()]
    if not placed or _rank() == 0:
        _write(root, final, step, list(flat), leaves, extra)
    if placed and dist.get_world_size() > 1:
        dist.barrier()
    return final


def _write(root: str, final: str, step: int, paths: List[str],
           leaves: List[torch.Tensor], extra: Optional[dict]) -> None:
    os.makedirs(root, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shard_path = os.path.join(tmp, "shard_00000.npz")
    np.savez(shard_path, **{f"leaf_{i:05d}": _to_numpy(t)
                            for i, t in enumerate(leaves)})
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": [list(t.shape) for t in leaves],
        "dtypes": [str(t.dtype).replace("torch.", "") for t in leaves],
        "shards": {"shard_00000.npz": _sha256(shard_path)},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    latest_tmp = os.path.join(root, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.rename(latest_tmp, os.path.join(root, "LATEST"))


def verify(ckpt_dir: str) -> bool:
    """The manifest reads and every shard matches its sha256."""
    try:
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            manifest = json.load(f)
        for shard, digest in manifest["shards"].items():
            if _sha256(os.path.join(ckpt_dir, shard)) != digest:
                return False
        return True
    except (OSError, json.JSONDecodeError, KeyError):
        return False


def available_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_valid(root: str) -> Optional[str]:
    """Newest checkpoint that passes verification: ``LATEST``'s first,
    then the steps newest first (a corrupt one is skipped)."""
    latest_file = os.path.join(root, "LATEST")
    candidates = []
    if os.path.exists(latest_file):
        with open(latest_file) as f:
            candidates.append(os.path.join(root, f.read().strip()))
    for s in reversed(available_steps(root)):
        p = os.path.join(root, f"step_{s:08d}")
        if p not in candidates:
            candidates.append(p)
    for c in candidates:
        if os.path.isdir(c) and verify(c):
            return c
    return None


def restore(ckpt_dir: str, like: Optional[Dict[str, Any]] = None
            ) -> Tuple[Dict[str, Any], dict]:
    """(state, extra) of a checkpoint.  With ``like`` (a tree of tensors)
    the saved leaves must be exactly like's names and shapes, and each
    comes back on like's leaf's device; without, on the CPU.  Dtypes are
    the saved ones."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    want = _flatten(like) if like is not None else None
    if want is not None and list(want) != manifest["paths"]:
        missing = sorted(set(want) - set(manifest["paths"]))
        unknown = sorted(set(manifest["paths"]) - set(want))
        raise ValueError(f"{ckpt_dir}: leaves differ from the state's "
                         f"(missing {missing[:4]}, unknown {unknown[:4]})")
    flat = {}
    with np.load(os.path.join(ckpt_dir, "shard_00000.npz")) as data:
        for i, name in enumerate(manifest["paths"]):
            t = _from_numpy(data[f"leaf_{i:05d}"], manifest["dtypes"][i])
            shape = tuple(manifest["shapes"][i])
            if tuple(t.shape) != shape:
                raise ValueError(f"{ckpt_dir}: leaf {name} has shape "
                                 f"{tuple(t.shape)}, manifest {shape}")
            if want is not None:
                ref = torch.as_tensor(want[name])
                if tuple(ref.shape) != shape:
                    raise ValueError(f"{ckpt_dir}: leaf {name} is {shape}, "
                                     f"the state's {tuple(ref.shape)}")
                t = t.to(ref.device)
            flat[name] = t
    return _unflatten(flat), manifest["extra"]


def restore_resharded(ckpt_dir: str, like: Dict[str, Any], mesh,
                      shardings: Dict[str, Any]
                      ) -> Tuple[Dict[str, Any], dict]:
    """Elastic restore: ``restore`` (against ``like``'s names and whole
    shapes; DTensor leaves count by their global shape), then every leaf
    placed under ``shardings`` (a tree like ``like`` of specs or
    placements, ``launch.sharding.place``) on ``mesh``."""
    from repro_torch.launch import sharding as shard_mod
    state, extra = restore(ckpt_dir, like)
    return shard_mod.place(state, mesh, shardings), extra


def prune(root: str, keep: int = 3) -> None:
    steps = available_steps(root)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)
