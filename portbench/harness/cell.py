"""One cell of the benchmark: a configuration served under a traffic mix.

``Cell`` builds the program under test from the cell's files (the
configuration's sizes, the family reference's weight list, the mix), runs
the closed loop through a set-up ramp, the measured window and, traced,
a few seconds more, then frees the program and holds what it served to
the reference.
"""
from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, trace
from .loop import ClosedLoop
from .traffic import Traffic
from .weights import Draw, load_into
from .window import PEAKS, Window

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def read_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def bench_file() -> Dict:
    return read_json(ROOT.parent / "BENCHMARK.json")


def cell_files(workload: str, bench: Optional[Dict] = None) -> Dict:
    """The cell's entry, its configuration and mix files, its limits."""
    bench = bench or bench_file()
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"cell": cell,
            "config": read_json(ROOT.parent / conf["file"]),
            "mix": read_json(ROOT / "traffic" / f"{cell['traffic']}.json"),
            "limits": read_json(ROOT / "limits" / f"{workload}.json")}


def model_config(port: Dict):
    """The program's ``ModelConfig`` from the configuration file's
    ``port`` section."""
    from repro_torch.configs import base
    kw = dict(port)
    for key, cls in (("ssm", base.SSMConfig), ("moe", base.MoEConfig),
                     ("mla", base.MLAConfig)):
        if kw.get(key) is not None:
            kw[key] = cls(**kw[key])
    return base.ModelConfig(**kw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    def __init__(self, files: Dict, seed: int, device: torch.device):
        self.files, self.seed, self.device = files, seed, device
        self.config, self.mix = files["config"], files["mix"]
        self.port = self.config["port"]
        self.ref = trace.load_module("reference", self.config["reference"])
        self.leaves = self.ref.leaves(self.port)
        self.kernels: List[str] = list(self.config.get("kernels", []))
        self.engine = self.sched = self.loop = self.draw = None

    # ------------------------------------------------------------ set-up --
    def build(self) -> None:
        """The weights drawn from the seed, the program's model over them,
        its engine (whose warmup plans or replays every kernel plan of the
        engine's grid) and a prefill at the mix's longest prompt."""
        from repro_torch.models import model as model_mod
        from repro_torch.serve.engine import Engine, ServeConfig
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build_all()
        cfg = model_config(self.port)
        self.draw = Draw(self.leaves, self.seed, self.device,
                         cfg.activation_dtype)
        with torch.device("meta"):
            model = model_mod.build(cfg, cfg.activation_dtype)
        load_into(model, self.draw)
        scfg = ServeConfig(batch=1, max_len=int(self.mix["max_len"]),
                           cache_dtype=self.config["serve"]["cache_dtype"])
        self.engine = Engine(cfg, model, scfg, device=self.device)
        longest = torch.zeros((1, int(self.mix["prompt"]["max"])),
                              dtype=torch.long)
        self.engine.prefill(longest)
        _sync(self.device)

    def start(self, seed: Optional[int] = None) -> None:
        """A new scheduler over the engine and the loop's clients, then the
        mix's ramp of steps (which also plans decode at the full slots)."""
        from repro_torch.serve import scheduler as sched_mod
        seed = self.seed if seed is None else seed
        self.sched = sched_mod.Scheduler(self.engine,
                                         max_slots=int(self.mix["slots"]),
                                         step_time_ms=1.0)
        tr = Traffic(self.mix, seed, int(self.port["vocab_size"]))
        self.loop = ClosedLoop(self.sched, tr, sched_mod.Request)
        self.loop.start()
        for _ in range(int(self.mix["ramp_steps"])):
            self.loop.step()
        _sync(self.device)

    def redraw(self, seed: int) -> None:
        """New weights from ``seed`` in the same buffers (the control's
        run of many seeds in one process)."""
        self.draw.fill(seed)
        self.seed = seed

    def registry_stats(self) -> Optional[Dict]:
        reg = getattr(self.engine, "_reg", None)
        return None if reg is None else reg.stats.as_dict()

    # ------------------------------------------------------------ window --
    @contextlib.contextmanager
    def timed_prefills(self):
        """The engine's prefill with a host clock that ends in a
        synchronize, each call's seconds added to the loop's step."""
        eng, loop, dev = self.engine, self.loop, self.device
        orig = eng.prefill

        def timed(tokens, enc_out=None):
            t = time.perf_counter()
            out = orig(tokens, enc_out)
            _sync(dev)
            loop.add_prefill_time(time.perf_counter() - t)
            return out

        eng.prefill = timed
        try:
            yield
        finally:
            del eng.prefill

    def window(self, seconds: float, *, timed: bool) -> Window:
        t0 = time.perf_counter()
        with self.timed_prefills() if timed else contextlib.nullcontext():
            steps = self.loop.run_for(seconds)
        return Window(steps, self.loop.reqs, t0, self.port,
                      int(self.mix["slots"]), self.ref.token_flops)

    @contextlib.contextmanager
    def _labels(self):
        """Host labels around the engine's prefill and decode step, for the
        idle gaps of the trace."""
        rf = torch.profiler.record_function
        eng = self.engine
        orig = {"prefill": eng.prefill, "decode_token": eng.decode_token}

        def wrap(name, fn):
            def f(*a, **k):
                with rf(f"portbench.{name}"):
                    return fn(*a, **k)
            return f

        for name, fn in orig.items():
            setattr(eng, name, wrap(name, fn))
        try:
            yield
        finally:
            for name in orig:
                delattr(eng, name)

    def traced(self, seconds: float, out_path: Path, warn) -> Dict:
        """The loop for ``seconds`` more under ``torch.profiler``; returns
        the reduced trace with each kernel's roofline share."""
        from torch.profiler import ProfilerActivity, profile, record_function
        names = trace.counters_of(self.kernels)
        before = trace.launch_counts(names)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW), self._labels():
                steps = self.loop.run_for(seconds)
                _sync(self.device)
        after = trace.launch_counts(names)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out_path))
        del prof
        reduced = trace.reduce_trace(out_path)
        out_path.unlink()
        launches = {n: after[n] - before[n] for n in names}
        reduced["launches"] = launches
        reduced["roofline"] = trace.roofline(
            self.port, steps, reduced, self.kernels, launches, PEAKS, warn)
        return reduced

    # ------------------------------------------------------------- check --
    def release(self) -> None:
        """Free the program: scheduler, engine, model and weights."""
        if self.loop is not None:
            self.loop.sched = None
        self.sched = self.engine = self.draw = self.loop = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_gap(cell: Cell, sample) -> Dict:
    """Redraw the seed's weights (the program is freed) and run the
    reference over the sample."""
    from portbench.reference.common import strict_fp32
    strict_fp32()
    draw = Draw(cell.leaves, cell.seed, cell.device,
                getattr(torch, cell.port.get("dtype", "bfloat16")))
    try:
        return check.served_gap(cell.ref.forward, cell.port, draw.fp32,
                                sample, cell.device)
    finally:
        del draw
        gc.collect()

