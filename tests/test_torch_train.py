"""The port's training losses and gradients held to the JAX package, on
the CPU at SMOKE size, on the same params (the reference's
``init_params`` tree, loaded with ``convert.from_jax_params``) and the
same batches: ``loss_fn`` for all ten SMOKE archs within 1e-5; the
gradient of one arch of each family (dense, MoE with deepseek-v3's MTP
block, SSM, hybrid, enc-dec, VLM with its vision prefix), through the
remat'd blocks, within 1e-5 of the largest gradient value and each leaf
within 1e-4 of its own largest.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import load_arch as jload  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5          # of the largest gradient value of the model
LEAF_TOL = 1e-4          # of each leaf's own largest value
SMOKE_SHAPE = (32, 2)    # seq, batch: the reference's tests/test_archs.py
# one arch of each family: dense, MoE (+ MTP), SSM, hybrid, enc-dec, VLM
FAMILY_ARCHS = ("qwen3-0.6b", "deepseek-v3-671b", "mamba2-1.3b",
                "zamba2-2.7b", "whisper-base", "internvl2-2b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch):
    """(reference cfg, port cfg) of a SMOKE arch."""
    return jload(arch, smoke=True), pbase.load_arch(arch, smoke=True)


def _params(jcfg, pcfg, seed=0):
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return params, convert.from_jax_params(pcfg, _np(params))


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaf_pairs(pcfg, jtree):
    """(port name, reference leaf) of every leaf of a reference tree, the
    stacked segments un-stacked as ``convert`` loads them."""
    stacked = tuple(f"{n}." for n in convert._stacked(pcfg))
    for name, arr in convert._flatten(_np(jtree)).items():
        seg = next((p for p in stacked if name.startswith(p)), None)
        if seg is None:
            yield name, arr
        else:
            for i in range(arr.shape[0]):
                yield f"{seg}{i}.{name[len(seg):]}", arr[i]


# ----------------------------------------------------------------- losses --
@pytest.mark.parametrize("arch", pbase.ARCH_IDS)
def test_loss_matches_reference(arch):
    jcfg, pcfg = _pair(arch)
    params, model = _params(jcfg, pcfg)
    batch = jmodel.example_batch(jcfg, JShape("s", *SMOKE_SHAPE, "train"))
    want = float(jax.jit(lambda p: jmodel.loss_fn(jcfg, p, batch))(params))
    with torch.no_grad():
        got = float(pmodel.loss_fn(pcfg, model, _to_torch(batch)))
    assert abs(got - want) <= LOSS_TOL * max(1.0, abs(want))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_gradients_match_reference(arch):
    """Each family's gradient, MTP (deepseek-v3) and the vision prefix
    (internvl2) included, through the remat'd blocks."""
    jcfg, pcfg = _pair(arch)
    assert pcfg.remat
    params, model = _params(jcfg, pcfg)
    batch = jmodel.example_batch(jcfg, JShape("s", *SMOKE_SHAPE, "train"))
    want = jax.jit(jax.grad(lambda p: jmodel.loss_fn(jcfg, p, batch)))(
        params)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss = pmodel.loss_fn(pcfg, model, _to_torch(batch))
    got = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                              allow_unused=True)))
    pairs = list(_leaf_pairs(pcfg, want))
    assert {n for n, _ in pairs} == set(named)
    top = max(float(np.abs(a).max()) for _, a in pairs)
    for name, a in pairs:
        g = got[name]
        g = np.zeros_like(a) if g is None else g.numpy()
        diff = float(np.abs(g - a).max())
        assert diff <= GRAD_TOL * top, (name, diff, top)
        assert diff <= LEAF_TOL * float(np.abs(a).max()) + 1e-12, name


def test_vision_prefix_and_mtp_carry_gradient():
    """The VLM's projector and deepseek-v3's MTP block get nonzero
    gradients (the prefix positions carry no labels, but attend)."""
    for arch, prefix in (("internvl2-2b", "projector."),
                         ("deepseek-v3-671b", "mtp.")):
        _jcfg, pcfg = _pair(arch)
        model = convert.init_params(pcfg, torch.Generator().manual_seed(0))
        model.requires_grad_(True)
        batch = pmodel.example_batch(pcfg, pbase.ShapeConfig("s", 16, 2,
                                                             "train"))
        pmodel.loss_fn(pcfg, model, batch).backward()
        grads = [p.grad for n, p in model.named_parameters()
                 if n.startswith(prefix)]
        assert grads and all(g is not None and g.abs().max() > 0
                             for g in grads), arch


