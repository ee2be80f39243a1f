"""Readings that a cell's ``max_gap`` limit is set from, many seeds in one
process (the benchmark's own runs never run this).

    python3 portbench/control.py --workload qwen2-7b.code \
        --seeds 11,12,13 --seconds 10 [--control 3]

For each seed: new weights in the program's buffers, a new scheduler and
the mix's ramp, a window of ``--seconds`` at the cell's own load, and the
sample a run draws.  Then the scheduler is freed and the fp32 reference
reads the widest gap of the served tokens (the program's reading, the
lower end of the limit); for the first ``--control`` seeds also the
control's, the reference on fp8 weights in the program's place (the upper
end).  One JSON line per seed, then one with the extremes.
"""
import argparse
import gc
import json
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    run.set_paths()
    import torch

    from portbench.harness import check
    from portbench.harness.cell import Cell, cell_files, log
    from portbench.reference.common import (fp8_weights, matrix_names,
                                            strict_fp32)

    seeds = [int(s) for s in args.seeds.split(",")]
    files = cell_files(args.workload)
    mix = files["mix"]
    dev = torch.device("cuda", 0)
    cell = Cell(files, seeds[0], dev)
    cell.build()
    low_names = matrix_names(cell.leaves)
    lows, highs = [], []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        if i:
            cell.redraw(seed)
        cell.start(seed)
        w = cell.window(args.seconds, timed=False)
        s = check.sample(w.completed(), seed, int(mix["sample"]["requests"]),
                         int(mix["sample"]["tokens"]))
        cell.sched = cell.loop = None
        gc.collect()
        torch.cuda.empty_cache()
        strict_fp32()
        rec = {"seed": seed, "window_s": w.seconds,
               "finished": len(w.completed())}
        got = check.served_gap(cell.ref.forward, cell.port, cell.draw.fp32,
                               s, dev)
        rec["program"] = got
        lows.append(got)
        if i < args.control:
            ctl = check.control_gap(cell.ref.forward, cell.port,
                                    cell.draw.fp32,
                                    fp8_weights(cell.draw.fp32, low_names),
                                    s, dev)
            rec["control"] = ctl
            highs.append(ctl)
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec), flush=True)
        log(f"seed {seed}: {rec}")
    keys = ("max_gap", "mean_gap", "miss_share")
    print(json.dumps({
        "workload": args.workload, "seeds": len(seeds),
        "lower": {k: max(r[k] for r in lows) for k in keys},
        "upper": {k: min(r[k] for r in highs) for k in keys} if highs
        else None,
        "device": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
