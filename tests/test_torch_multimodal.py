"""The port's VLM family (internvl2-2b) against the JAX package, on the
CPU in fp32 (SMOKE), where the ops take their plain versions and no kernel
launches.

* ``project`` (LayerNorm over d_vision, biased fc1, tanh GELU, biased
  fc2) within 1e-5, with seeded nonzero projector biases and norm.
* ``model.forward`` with patches: logits over ``n_vision_tokens + S``
  positions (``tests/test_archs.py:28``), and ``last_only``, within 1e-5
  on both ``attention_impl`` values.
* ``from_jax_params`` loads the dense tree plus ``projector``.
* ``Engine.generate`` against the JAX engine's (text only, as the
  reference serves the family): identical greedy tokens, logits 1e-5.
* A stream through both packages' schedulers: snapshots equal every step,
  tokens identical, logits within 1e-5.
* ``launch.serve --arch internvl2-2b`` serves it.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.kernels import decode_attention as port_da  # noqa: E402
from repro_torch.kernels import flash_attention as port_fa  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import multimodal as port_mm  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402
from repro_torch.serve import scheduler as port_sched  # noqa: E402

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, PROMPT, NEW = 2, 8, 4
IMPLS = ("pallas", "xla_chunked")


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _patches(seed=9, batch=BATCH):
    cfg = load_arch("internvl2-2b", smoke=True)
    return (np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_vision_tokens, cfg.d_vision)) * 2.0).astype(np.float32)


def _launches():
    return port_fa.launches, port_da.launches


def _configs(impl):
    """(reference SMOKE on direct plans, port SMOKE) at ``impl``."""
    from repro.configs import internvl2_2b as jv
    return (dataclasses.replace(jv.SMOKE, attention_impl=impl,
                                kernel_plan="direct"),
            dataclasses.replace(load_arch("internvl2-2b", smoke=True),
                                attention_impl=impl))


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference's ``init_params(SMOKE)`` with seeded nonzero projector
    biases and norm (the reference initialises them to zeros and ones), as
    (JAX params, numpy tree, port model)."""
    from repro.configs import internvl2_2b as jv
    from repro.models import model as jm
    tree = jax.tree.map(np.array, jm.init_params(jv.SMOKE,
                                                 jax.random.PRNGKey(0)))
    rng = np.random.default_rng(23)
    proj = tree["projector"]
    for leaf in (proj["norm"]["bias"], proj["fc1"]["b"], proj["fc2"]["b"]):
        leaf[...] = rng.standard_normal(leaf.shape) * 0.1
    proj["norm"]["scale"][...] += rng.standard_normal(
        proj["norm"]["scale"].shape) * 0.1
    return (jax.tree.map(jnp.asarray, tree), tree,
            convert.from_jax_params(load_arch("internvl2-2b", smoke=True),
                                    tree))


def test_model_is_the_dense_backbone_plus_projector():
    params, tree, model = _weights()
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    assert isinstance(model, port_mm.VLM)
    names = model.state_dict()
    assert sorted(n for n in names if n.startswith("projector.")) == [
        "projector.fc1.b", "projector.fc1.w", "projector.fc2.b",
        "projector.fc2.w", "projector.norm.bias", "projector.norm.scale"]
    np.testing.assert_array_equal(names["projector.fc1.w"].numpy(),
                                  tree["projector"]["fc1"]["w"])
    np.testing.assert_array_equal(names["blocks.1.attn.wq.w"].numpy(),
                                  tree["blocks"]["attn"]["wq"]["w"][1])
    cfg = load_arch("internvl2-2b", smoke=True)
    cut = {k: v for k, v in tree.items() if k != "projector"}
    with pytest.raises(RuntimeError, match="Missing key"):
        convert.from_jax_params(cfg, cut)


def test_project_matches_reference():
    from repro.models import multimodal as jmm
    params, _, model = _weights()
    jcfg, pcfg = _configs("xla_chunked")
    pt = _patches()
    want = jmm.project(jcfg, params, jnp.asarray(pt))
    got = port_mm.project(pcfg, model, torch.from_numpy(pt))
    assert tuple(got.shape) == (BATCH, pcfg.n_vision_tokens, pcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_with_patches_matches_reference(impl):
    from repro.models import model as jm
    params, _, model = _weights()
    jcfg, pcfg = _configs(impl)
    pt, toks = _patches(), _tokens(1, (BATCH, 12))
    batch_j = {"patches": jnp.asarray(pt), "tokens": jnp.asarray(toks)}
    batch_p = {"patches": torch.from_numpy(pt),
               "tokens": torch.from_numpy(toks)}
    want, want_aux = jm.forward(jcfg, params, batch_j)
    before = _launches()
    got, aux = port_model.forward(pcfg, model, batch_p)
    assert _launches() == before
    assert tuple(got.shape) == (BATCH, pcfg.n_vision_tokens + 12,
                                pcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert float(aux) == float(want_aux)
    want_last, _ = jm.forward(jcfg, params, batch_j, last_only=True)
    last, _ = port_model.forward(pcfg, model, batch_p, last_only=True)
    assert tuple(last.shape) == (BATCH, 1, pcfg.vocab_size)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               **LOGIT_TOL)
    # the patches are read: other patches give other logits
    other, _ = port_model.forward(pcfg, model, dict(
        batch_p, patches=torch.from_numpy(_patches(10))), last_only=True)
    assert float((other - last).abs().max()) > 1e-3


@functools.lru_cache(maxsize=None)
def _engines(impl, max_len=PROMPT + NEW + 1, batch=BATCH):
    from repro.serve.engine import Engine, ServeConfig
    params, _, model = _weights()
    jcfg, pcfg = _configs(impl)
    jeng = Engine(jcfg, params, ServeConfig(batch=batch, max_len=max_len,
                                            warmup=False,
                                            kernel_plan="direct"))
    peng = port_engine.Engine(pcfg, model, port_engine.ServeConfig(
        batch=batch, max_len=max_len), device="cpu")
    return jeng, peng


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_matches_reference_engine(impl):
    jeng, peng = _engines(impl)
    prompts = _tokens(3, (BATCH, PROMPT))
    want, wlog = jeng.generate(jnp.asarray(prompts), NEW, return_logits=True)
    before = _launches()
    got, glog = peng.generate(torch.from_numpy(prompts), NEW,
                              return_logits=True)
    assert _launches() == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(glog.numpy(), np.asarray(wlog), **LOGIT_TOL)


def test_stream_matches_reference_scheduler():
    """The VLM served as a dense decoder through continuous batching, as
    the reference's scheduler serves it: a chunked trace, snapshot for
    snapshot."""
    from repro.serve import scheduler as jax_sched
    jeng, peng = _engines("pallas", max_len=32, batch=4)
    wl = dict(n_requests=5, seed=8, prompt_lens=(3, 9), new_tokens=(2, 4),
              arrival_rate=0.7, vocab=peng.cfg.vocab_size)
    kw = dict(prefill_chunk_tokens=4, collect_logits=True,
              return_shed=True, step_time_ms=1.0)
    jsnaps, psnaps = [], []
    jdone, _ = jeng.serve_stream(jax_sched.synthetic_workload(**wl),
                                 step_hook=jsnaps.append, **kw)
    before = _launches()
    pdone, _ = peng.serve_stream(port_sched.synthetic_workload(**wl),
                                 step_hook=psnaps.append, **kw)
    assert _launches() == before
    assert len(psnaps) == len(jsnaps) and psnaps == jsnaps
    assert any(s["prefilling"] for s in psnaps), "no chunked prefill"
    assert [r.rid for r in pdone] == [r.rid for r in jdone]
    for p, j in zip(pdone, jdone):
        np.testing.assert_array_equal(p.tokens, j.tokens,
                                      err_msg=f"rid {j.rid}")
        np.testing.assert_allclose(p.logits, j.logits, err_msg=f"rid {j.rid}",
                                   **LOGIT_TOL)


def test_serve_cli_runs_internvl2_on_cpu(capsys):
    from repro_torch.launch import serve
    before = _launches()
    out = serve.main(["--arch", "internvl2-2b", "--smoke", "--device", "cpu",
                      "--attention-impl", "pallas", "--batch", "2",
                      "--prompt-len", "8", "--new", "4"])
    assert tuple(out.shape) == (2, 4)
    assert _launches() == before
    text = capsys.readouterr().out
    assert "[serve] internvl2-smoke on cpu (pallas, text only)" in text
    assert "[serve] first sequence:" in text
