"""What a run loads and where it writes: a whole run on the CPU (the tiny
cell) leaves no module of JAX or of the JAX package in ``sys.modules``,
compared by whole top-level names, and the caches sit inside the
checkout."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SCRIPT = """
import sys, torch
sys.path[:0] = [{repo!r}, {src!r}, {tests!r}]
import run
run.set_paths()
import small
from portbench.harness.cell import log
out = run.run_cell(small.files(small.SSM), {{"end_to_end": [], "per_layer": []}},
                   7, 0.3, True, torch.device("cpu"), 0.0, log)
print("FORBIDDEN", run.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    code = SCRIPT.format(repo=str(REPO), src=str(REPO / "src"),
                         tests=str(REPO / "portbench" / "tests"))
    env = dict(os.environ, PYTHONPATH=str(REPO / "portbench"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_are_whole():
    import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.serve",
                                  "jaxtyping", "reprox"]) == []
    assert run.forbidden_modules(["jax.numpy", "repro.core", "flax",
                                  "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                 "repro"]


def test_caches_inside_the_checkout(monkeypatch):
    import run
    for var in ("REPRO_TORCH_CACHE_DIR", "TRITON_CACHE_DIR",
                "TORCH_EXTENSIONS_DIR"):
        monkeypatch.delenv(var, raising=False)
    run.set_paths()
    for var in ("REPRO_TORCH_CACHE_DIR", "TRITON_CACHE_DIR",
                "TORCH_EXTENSIONS_DIR"):
        assert Path(os.environ[var]).is_relative_to(REPO / "build")


def test_nothing_reads_the_old_benchmarks():
    for path in (REPO / "portbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import benchmarks" not in text
        assert "import jax" not in text and "from repro " not in text \
            and "from repro." not in text and "import repro\n" not in text
