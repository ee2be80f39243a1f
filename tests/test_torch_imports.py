"""Import boundary of the PyTorch port: it runs without JAX and without the
reference package, and its entry points default to the card."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(n == 'jax' or n.startswith(('jax.', 'repro.'))\n"
        "               for n in sys.modules if sys.modules[n] is not None)\n"
        "print('ok')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_distribution_surface_exists():
    """The distribution slice's modules and entry points (the reference's
    ``launch/{mesh,sharding,steps,dryrun,__main__}.py``,
    ``restore_resharded``, ``elastic_remesh``, the launcher's mesh flags,
    ``mesh=`` on the trainer and the engine)."""
    import inspect

    from repro_torch.checkpoint import manager
    from repro_torch.launch import __main__ as dispatch
    from repro_torch.launch import dryrun, mesh, sharding, steps
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import failover
    from repro_torch.serve.engine import Engine
    from repro_torch.train import trainer
    for mod, names in (
            (mesh, ("make_production_mesh", "make_host_mesh",
                    "mesh_axis_sizes", "dp_degree", "fake_world",
                    "destroy_group")),
            (sharding, ("_fit", "_param_rule", "param_specs", "fit_specs",
                        "batch_spec", "batch_specs", "cache_specs",
                        "strip_axis", "constrain", "placements", "shardings",
                        "place")),
            (steps, ("abstract_params", "abstract_opt_state",
                     "abstract_batch", "abstract_decode_batch",
                     "abstract_cache", "train_shardings",
                     "make_prefill_step", "make_decode_step",
                     "serve_shardings", "make_train_step")),
            (dryrun, ("run_cell", "main")), (dispatch, ("main",)),
            (manager, ("restore_resharded",)),
            (failover, ("elastic_remesh",))):
        for name in names:
            assert callable(getattr(mod, name, None)), (mod.__name__, name)
    assert set(dispatch.COMMANDS) == {"tune", "serve"}
    src = inspect.getsource(launch_train)
    assert "--production-mesh" in src and "--multi-pod" in src
    for fn in (trainer.train, trainer.make_trainer, Engine.__init__):
        assert "mesh" in inspect.signature(fn).parameters


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve("cuda")
    assert device.resolve("cpu") == torch.device("cpu")


def test_device_below_hopper_raises(monkeypatch):
    from repro_torch import device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "A100")
    with pytest.raises(RuntimeError, match="sm_90a"):
        device.resolve()


def test_engine_defaults_to_cuda(monkeypatch):
    from repro_torch.configs.qwen3_0_6b import SMOKE
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import Engine, ServeConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(SMOKE, model_mod.build(SMOKE), ServeConfig())


def test_kernel_build_key_follows_source(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.lib_path("k")
    (src / "k.cu").write_text("// two\n")
    assert _build.lib_path("k") != first
    assert first.parent == _build.BUILD_DIR


def test_tuner_defaults_to_cuda(monkeypatch, tmp_path):
    """The tuner measures on the card unless asked for the CPU."""
    from repro_torch.configs.qwen3_0_6b import SMOKE
    from repro_torch.launch import tune
    from repro_torch.tune.worker import run_fleet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_fleet(SMOKE, 2, 16, ledger_path=tmp_path / "l.json",
                  store_path=tmp_path / "s.json")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tune.main(["--arch", "qwen3-0.6b", "--smoke",
                   "--work-dir", str(tmp_path / "w")])


def test_trainer_defaults_to_cuda(monkeypatch, tmp_path):
    """The trainer and its launcher train on the card unless asked for the
    CPU."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.qwen3_0_6b import SMOKE
    from repro_torch.data.pipeline import synthetic_batch, DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import TrainConfig, make_trainer, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shape = ShapeConfig("t", 16, 2, "train")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(SMOKE, shape, tcfg=TrainConfig(n_steps=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_trainer(SMOKE, shape)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                           "--ckpt", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()
    # the data stream draws where it is told (the trainer tells it its
    # device); on its own it draws on the host
    assert synthetic_batch(SMOKE, shape, DataConfig(), 0)["tokens"] \
        .device.type == "cpu"
