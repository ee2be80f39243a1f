"""Offline tuner launcher: measure the plan grid once, publish an artifact,
the port of ``repro.launch.tune``.

    PYTHONPATH=src python -m repro_torch.launch.tune --arch qwen3-0.6b \\
        --batch 8 --max-len 577 --device cuda --out plans.artifact.json

Runs one tuner worker (:mod:`repro_torch.tune`) against a shared lease
ledger and compile-cache store: the (kernel x bucket) grid is enumerated
from the config (the grid ``Engine.warmup`` plans at that batch and
``max_len``, with the engine's default float32 KV cache), deduped by
compile-cache key, sharded, and drained under heartbeat-stamped leases.
Run the same command several times on one ``--work-dir`` and the workers
partition the grid; on one card they also take turns at it, one
measurement at a time under a lock file in the work directory.  A worker
killed mid-measurement loses its lease and a survivor reclaims the shard.
The published artifact is schema-versioned with a per-entry verified
manifest (partial results are salvaged), and ``launch.serve
--plan-artifact`` (``ServeConfig.plan_artifact``) warm-starts replicas from
it with zero autotune measurements.  ``--device`` (default the card) is
where plans are measured; a replica on another kind of device rejects
them as stale.  The last line of output is one JSON object: the worker's
counts, its card-lock wait, its measurement intervals and the artifact.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64,
                    help="tune the bucket grid up to this sequence length "
                         "(match the serving ServeConfig.max_len)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="publish the plan artifact to PATH (default: "
                         "<work-dir>/plans.artifact.json)")
    ap.add_argument("--work-dir", default=None, metavar="DIR",
                    help="shared fleet directory for the lease ledger, the "
                         "plan store and the card lock (default: "
                         "$REPRO_TORCH_CACHE_DIR or ~/.cache/repro_torch)")
    ap.add_argument("--worker-id", default=None,
                    help="fleet member id (default: tuner-<pid>)")
    ap.add_argument("--shards", type=int, default=4,
                    help="lease shards to partition the grid into")
    ap.add_argument("--ttl", type=float, default=30.0, metavar="S",
                    help="lease TTL: a worker silent for S seconds loses "
                         "its shard to reclaim")
    ap.add_argument("--backend", default="hopper", choices=("hopper",))
    ap.add_argument("--attention-impl", default=None)
    ap.add_argument("--ssm-impl", default=None)
    ap.add_argument("--device", default=None,
                    help="where plans are measured: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import load_arch
    from repro_torch.tune import run_fleet

    cfg = load_arch(args.arch, smoke=args.smoke)
    overrides = {k: v for k, v in (("attention_impl", args.attention_impl),
                                   ("ssm_impl", args.ssm_impl)) if v}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    work_dir = Path(args.work_dir or os.environ.get("REPRO_TORCH_CACHE_DIR")
                    or (Path.home() / ".cache" / "repro_torch"))
    out = Path(args.out) if args.out else work_dir / "plans.artifact.json"
    worker_id = args.worker_id or f"tuner-{os.getpid()}"

    rep = run_fleet(cfg, args.batch, args.max_len,
                    ledger_path=work_dir / "tune_ledger.json",
                    store_path=work_dir / "compile_cache.json",
                    out_path=out, n_shards=args.shards,
                    worker_id=worker_id, ttl_s=args.ttl,
                    backend=args.backend, device=args.device)

    w = rep["worker"]
    print(f"[tune] {worker_id} on {rep['device']}: grid {rep['work_items']} "
          f"request(s) -> {rep['groups']} deduped group(s); measured "
          f"{w['measured']}, replayed {w['replayed']}, failed "
          f"{len(w['failed'])} in {rep['wall_s']:.3f} s, card lock waited "
          f"{w['lock_wait_s']:.3f} s")
    print("[tune] ledger: "
          + ", ".join(f"{k}={v}" for k, v in sorted(rep["ledger"].items()))
          + (f"; lease errors {w['lease_errors']}"
             if w["lease_errors"] else ""))
    if w["shards_lost"]:
        print(f"[tune] LOST LEASES: {len(w['shards_lost'])} shard(s) "
              f"reclaimed by other workers; their results publish from "
              f"the new owners")
    art = rep.get("artifact")
    if art:
        status = "complete" if art["complete"] else \
            f"SALVAGED ({art['missing']} group(s) unmeasured)"
        print(f"[tune] artifact: {art['entries']} plan(s) -> {art['path']} "
              f"[{status}]")
        print(f"[tune] serve replicas warm-start with: "
              f"python -m repro_torch.launch.serve --arch {args.arch} "
              f"--kernel-plan measure --plan-artifact {art['path']}")
    print(json.dumps({"worker": worker_id, "device": rep["device"],
                      "groups": rep["groups"],
                      "work_items": rep["work_items"],
                      "measured": w["measured"],
                      "replayed": w["replayed"],
                      "failed": len(w["failed"]),
                      "wall_s": rep["wall_s"],
                      "lock_wait_s": w["lock_wait_s"],
                      "intervals": w["intervals"],
                      "artifact": art}))
    return rep


if __name__ == "__main__":
    main()
