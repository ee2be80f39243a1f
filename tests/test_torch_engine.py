"""The port's Engine against the JAX Engine: same weights, same prompts,
identical greedy tokens (SMOKE, fp32, CPU)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.configs import qwen3_0_6b as port_qwen3  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402

BATCH, PROMPT, NEW = 2, 8, 8


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))


@pytest.mark.parametrize("impl", ["pallas", "xla_chunked"])
def test_greedy_tokens_match_reference_engine(impl):
    from repro.configs import qwen3_0_6b as jax_qwen3
    from repro.models import transformer as jax_tf
    from repro.serve.engine import Engine, ServeConfig
    jcfg = dataclasses.replace(jax_qwen3.SMOKE, attention_impl=impl)
    params = jax_tf.init_params(jcfg, jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    max_len = PROMPT + NEW + 1
    want = Engine(jcfg, params, ServeConfig(batch=BATCH, max_len=max_len,
                                            warmup=False,
                                            kernel_plan="direct")
                  ).generate(jnp.asarray(prompts), NEW)

    pcfg = dataclasses.replace(port_qwen3.SMOKE, attention_impl=impl)
    model = convert.from_jax_params(pcfg, jax.tree.map(np.asarray, params))
    eng = port_engine.Engine(pcfg, model,
                             port_engine.ServeConfig(batch=BATCH,
                                                     max_len=max_len),
                             device="cpu")
    got = eng.generate(torch.from_numpy(prompts).long(), NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    phases = eng.stats()["phases"]
    assert phases["prefill"]["steps"] == 0
    assert phases["decode"]["steps"] == NEW - 1
    assert eng.stats()["ttft_s"] > 0


def test_return_logits_are_the_chosen_distributions():
    model = convert.init_params(port_qwen3.SMOKE,
                                torch.Generator().manual_seed(0))
    eng = port_engine.Engine(port_qwen3.SMOKE, model,
                             port_engine.ServeConfig(batch=BATCH,
                                                     max_len=PROMPT + NEW),
                             device="cpu")
    prompts = torch.randint(0, 256, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    toks, logits = eng.generate(prompts, NEW, return_logits=True)
    assert toks.shape == (BATCH, NEW)
    assert logits.shape == (NEW, BATCH, port_qwen3.SMOKE.vocab_size)
    assert logits.dtype == torch.float32
    torch.testing.assert_close(logits.argmax(-1).T, toks)


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "4", "--new", "3",
                      "--attention-impl", "pallas"])
    assert tuple(out.shape) == (2, 3)
    text = capsys.readouterr().out
    assert "generated (2, 3)" in text and "ms/step" in text


def test_init_params_follows_reference_distributions():
    cfg = port_qwen3.SMOKE
    model = convert.init_params(cfg, torch.Generator().manual_seed(3))
    emb = model.embed.embedding
    assert abs(emb.std().item() - 0.02) < 0.002
    w = model.blocks[0].mlp.down.w            # d_in = d_ff
    assert abs(w.std().item() * cfg.d_ff ** 0.5 - 1.0) < 0.05
    assert torch.equal(model.final_norm.scale, torch.ones(cfg.d_model))
    again = convert.init_params(cfg, torch.Generator().manual_seed(3))
    assert torch.equal(again.embed.embedding, emb)
    assert not any(p.requires_grad for p in model.parameters())
