"""Sampling at temperature > 0 in the port against the JAX package, on the
CPU.

* The key chain (``repro_torch.serve.prng``): ``PRNGKey``, ``split`` and
  ``fold_in`` give ``jax.random``'s key data exactly, over several seeds
  (negative and wider than 32 bits among them) and split chains; the
  32-bit raw bits and ``uniform`` are bit-exact at ``(1, V)``, ``(B, V)``
  and other shapes.
* ``categorical`` gives ``jax.random.categorical``'s tokens on seeded
  logits wherever the top two perturbed scores are farther apart than
  ``NEAR_TIE`` (relative); ``log`` differs by an ulp between the two
  libraries, so only a near tie may differ, and the near ties are
  counted.
* The scheduler's batched lane draw (``categorical_rows``) is bit for bit
  the L separate ``(1, V)`` draws.
* qwen3 SMOKE ``generate`` at temperature 0.7 gives the JAX engine's
  tokens apart from near ties, on both attention routes; a sampled stream
  equals the JAX scheduler's step for step (snapshots, tokens, logits) and
  each request's tokens equal its solo ``generate``, apart from near
  ties.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch.configs.base import load_arch  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402
from repro_torch.serve import prng  # noqa: E402
from repro_torch.serve import scheduler as port_sched  # noqa: E402

# two perturbed scores this close (relative to the larger) are a near tie:
# an ulp of log in the gumbel noise (about 5e-7 here) or of the logits
# between the two packages (1e-5 at SMOKE) may order them either way
NEAR_TIE = 1e-5
TEMP = 0.7
SEEDS = [0, 1, 42, 12345, -1, 2**31 - 1, 2**32 + 5]
VOCAB = 151936          # qwen3's vocabulary, the serving draw's width
BATCH, PROMPT, NEW, MAX_LEN = 2, 8, 8, 32


@pytest.fixture(autouse=True)
def _private_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax-cache"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))


def _jkey(key) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


def _logits(seed, shape, scale=3.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _gap(key, logits: torch.Tensor) -> torch.Tensor:
    """Each row's relative gap between its top two perturbed scores
    (gumbel noise plus the scaled logits) under the port's draw."""
    z = prng.gumbel(key, tuple(logits.shape)) + logits
    top = z.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) / top[..., 0].abs().clamp(min=1.0)


# ------------------------------------------------------------ key chain --
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_match_jax(seed):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert _jkey(jk) == pk
    for num in (2, 3, 8):
        want = np.asarray(jax.random.key_data(jax.random.split(jk, num)))
        assert [list(k) for k in prng.split(pk, num)] == want.tolist()
    for data in (0, 1, 7, 2**31 + 3, 2**32 - 1):
        assert _jkey(jax.random.fold_in(jk, data)) == prng.fold_in(pk, data)
    # the engine's chain: split the running key, keep the first half
    for _ in range(6):
        jk, jsub = jax.random.split(jk)
        pk, psub = prng.split(pk)
        assert (_jkey(jk), _jkey(jsub)) == (pk, psub)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1, VOCAB), (4, 1000), (8, 513), (5,),
                                   (3, 7, 11)])
def test_random_bits_and_uniform_are_bit_exact(seed, shape):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = prng.random_bits(pk, shape).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                   (-2.0, 3.0)):
        u = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        pu = prng.uniform(pk, shape, lo, hi).numpy()
        np.testing.assert_array_equal(pu.view(np.int32), u.view(np.int32))


def test_threefry_known_answer():
    """Threefry-2x32, 20 rounds, against the Random123 known-answer
    vectors (the test vectors jax's own tests use)."""
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
              (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
    for key, count, want in cases:
        assert prng.threefry2x32(*key, *count) == want


# ----------------------------------------------------------- categorical --
@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1, VOCAB), (8, 4096), (16, 256)])
def test_categorical_matches_jax_apart_from_near_ties(seed, shape):
    jk, pk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    logits = _logits(seed + 100, shape)
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    pl = torch.from_numpy(logits)
    got = prng.categorical(pk, pl).numpy()
    differ = got != want
    gaps = _gap(pk, pl).numpy()
    assert (gaps[differ] <= NEAR_TIE).all(), \
        f"tokens differ away from a near tie: gaps {gaps[differ]}"
    assert differ.sum() <= (gaps <= NEAR_TIE).sum()
    # the noise itself differs from jax's by ulps of log only
    noise = np.asarray(jax.random.gumbel(jk, shape, jnp.float32))
    np.testing.assert_allclose(prng.gumbel(pk, shape).numpy(), noise,
                               rtol=1e-6, atol=1e-6)


def test_categorical_rows_equals_separate_draws():
    """The batched lane draw: row l of one (L, V) draw with a key per row
    is, bit for bit, the (1, V) draw with key l alone."""
    keys = prng.split(prng.PRNGKey(3), 6) + [prng.PRNGKey(0)] * 2
    logits = torch.from_numpy(_logits(9, (len(keys), 5000)))
    got = prng.categorical_rows(keys, logits)
    for row, key in enumerate(keys):
        assert got[row] == prng.categorical(key, logits[row:row + 1])[0]
        # the perturbed scores themselves, bit for bit
        k0, k1 = prng._keys_tensor(keys, "cpu")
        z = prng._gumbel_of(prng._bits(k0, k1, (5000,), "cpu"))[row]
        assert torch.equal(z, prng.gumbel(key, (1, 5000))[0])
    # and against jax's per-lane draws (the reference scheduler's)
    for row, key in enumerate(keys):
        jk = jax.random.wrap_key_data(np.asarray(key, np.uint32))
        j = int(jax.random.categorical(jk, jnp.asarray(
            logits[row:row + 1].numpy()))[0])
        if j != int(got[row]):
            assert float(_gap(key, logits[row:row + 1])[0]) <= NEAR_TIE


def test_categorical_takes_float32_logits():
    with pytest.raises(TypeError, match="float32"):
        prng.categorical(prng.PRNGKey(0), torch.zeros(2, 8,
                                                      dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="keys"):
        prng.categorical_rows([prng.PRNGKey(0)], torch.zeros(2, 8))


# --------------------------------------------------------------- engines --
@functools.lru_cache(maxsize=None)
def _weights(arch="qwen3-0.6b"):
    from repro.configs.base import load_arch as jax_load_arch
    from repro.models import model as jax_model
    jcfg = jax_load_arch(arch, smoke=True)
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    model = convert.from_jax_params(load_arch(arch, smoke=True),
                                    jax.tree.map(np.asarray, params))
    return params, model


def _engines(impl, batch=BATCH, temperature=TEMP, seed=0):
    from repro.configs.base import load_arch as jax_load_arch
    from repro.serve.engine import Engine, ServeConfig
    params, model = _weights()
    jcfg = dataclasses.replace(jax_load_arch("qwen3-0.6b", smoke=True),
                               attention_impl=impl)
    jeng = Engine(jcfg, params, ServeConfig(
        batch=batch, max_len=MAX_LEN, warmup=False, kernel_plan="direct",
        temperature=temperature, seed=seed))
    pcfg = dataclasses.replace(load_arch("qwen3-0.6b", smoke=True),
                               attention_impl=impl)
    peng = port_engine.Engine(pcfg, model, port_engine.ServeConfig(
        batch=batch, max_len=MAX_LEN, temperature=temperature, seed=seed),
        device="cpu")
    return jeng, peng


def _chain(seed, n):
    """The engine's draw keys: PRNGKey(seed), then the second half of each
    split of the running key."""
    key = prng.PRNGKey(seed)
    out = [key]
    for _ in range(n - 1):
        key, sub = prng.split(key)
        out.append(sub)
    return out


def _lane_ties(got, want, logits, keys):
    """One request's tokens equal up to their first difference, which must
    sit at a near tie of the port's (1, V) draw at that step (after it the
    two continue from different tokens).  Returns 0 or 1, the near ties."""
    diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    if not len(diff):
        return 0
    i = int(diff[0])
    row = prng.scaled(torch.as_tensor(logits[i])[None], TEMP)
    gap = float(_gap(keys[i], row)[0])
    assert gap <= NEAR_TIE, f"differs at step {i}, gap {gap}"
    return 1


def _generate_ties(got, want, logits, keys):
    """As ``_lane_ties`` for ``generate``, whose step i draws all B rows
    at once with ``keys[i]`` (row b's counters at b * V)."""
    ties = 0
    for b in range(got.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if not len(diff):
            continue
        i = int(diff[0])
        full = prng.scaled(torch.from_numpy(logits[i]), TEMP)
        gap = float(_gap(keys[i], full)[b])
        assert gap <= NEAR_TIE, f"row {b} differs at step {i}, gap {gap}"
        ties += 1
    return ties


@pytest.mark.parametrize("impl", ["pallas", "xla_chunked"])
@pytest.mark.parametrize("seed", [0, 7])
def test_generate_sampled_matches_jax_engine(impl, seed):
    jeng, peng = _engines(impl, seed=seed)
    prompts = np.random.default_rng(seed).integers(
        0, peng.cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
    want = np.asarray(jeng.generate(jnp.asarray(prompts), NEW))
    toks, lgs = peng.generate(torch.from_numpy(prompts).long(), NEW,
                              return_logits=True)
    toks = toks.numpy()
    ties = _generate_ties(toks, want, lgs.numpy(), _chain(seed, NEW))
    assert ties < BATCH
    # sampling draws other tokens than the argmax (the chain is live)
    greedy = lgs.argmax(-1).T.numpy()
    assert (toks != greedy).any()


def test_generate_draws_on_the_logits_device_and_keeps_greedy():
    """Temperature 0 is still the argmax; the sampler's first token is
    ``categorical(PRNGKey(seed), last / T)`` on the prefill's logits."""
    _jeng, peng = _engines("pallas")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, peng.cfg.vocab_size, (BATCH, PROMPT))).long()
    toks, lgs = peng.generate(prompts, 2, return_logits=True)
    first = prng.categorical(prng.PRNGKey(0), prng.scaled(lgs[0], TEMP))
    assert torch.equal(toks[:, 0], first)
    _j, greedy = _engines("pallas", temperature=0.0)
    gt, glgs = greedy.generate(prompts, 3, return_logits=True)
    assert torch.equal(gt, glgs.argmax(-1).T)


# ---------------------------------------------------------------- streams --
STREAMS = {
    "fifo": (dict(n_requests=8, seed=11, prompt_lens=(3, 5, 8),
                  new_tokens=(2, 4, 6), arrival_rate=0.5), {}),
    "overload": (dict(n_requests=10, seed=7, prompt_lens=(2, 5, 9),
                      new_tokens=(2, 4, 6), arrival_rate=2.0,
                      priorities=(0, 1)),
                 dict(max_slots=2, prefill_chunk_tokens=4,
                      preempt_policy="lowest_priority")),
}


def _serve(eng, reqs, **kw):
    snaps = []
    done = eng.serve_stream(reqs, step_hook=snaps.append,
                            collect_logits=True, step_time_ms=1.0, **kw)
    return snaps, done


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_sampled_stream_matches_jax_scheduler_and_solo_runs(case):
    """Each lane carries its own key chain: the stream equals the JAX
    scheduler's step for step, and every request samples the tokens of
    its solo ``generate`` (a near tie apart; counted)."""
    from repro.serve import scheduler as jax_sched
    wl, kw = STREAMS[case]
    jeng, peng = _engines("pallas", batch=4)
    wl = dict(wl, vocab=peng.cfg.vocab_size)
    jsnaps, jdone = _serve(jeng, jax_sched.synthetic_workload(**wl), **kw)
    psnaps, pdone = _serve(peng, port_sched.synthetic_workload(**wl), **kw)
    assert psnaps == jsnaps
    assert [r.rid for r in pdone] == [r.rid for r in jdone]
    if case == "overload":
        assert sum(r.preemptions for r in pdone) >= 1
    ties = sampled = 0
    for p, j in zip(pdone, jdone):
        keys = _chain(0, len(p.tokens))
        ties += _lane_ties(p.tokens, j.tokens, p.logits, keys)
        np.testing.assert_allclose(p.logits, j.logits, rtol=1e-5, atol=1e-5)
        solo = peng.generate(torch.as_tensor(np.asarray(
            _prompt_of(wl, p.rid)))[None].long(), len(p.tokens))
        ties += _lane_ties(p.tokens, solo.numpy()[0], p.logits, keys)
        sampled += int((np.asarray(p.tokens)
                        != p.logits.argmax(-1)).any())
    assert ties <= 1, f"{ties} near ties"
    assert sampled, "no request drew a token other than its argmax"


def _prompt_of(wl, rid):
    reqs = port_sched.synthetic_workload(**wl)
    return next(r.tokens for r in reqs if r.rid == rid)


def test_lane_keys_survive_preemption():
    """A preempted lane keeps its key: its resumed tokens are those of the
    uninterrupted solo run (the resume's prefill draws nothing new)."""
    wl, kw = STREAMS["overload"]
    _jeng, peng = _engines("pallas", batch=4)
    wl = dict(wl, vocab=peng.cfg.vocab_size)
    _snaps, done = _serve(peng, port_sched.synthetic_workload(**wl), **kw)
    pre = [r for r in done if r.preemptions]
    assert pre
    for r in pre:
        solo = peng.generate(torch.as_tensor(
            np.asarray(_prompt_of(wl, r.rid)))[None].long(), len(r.tokens))
        assert _lane_ties(r.tokens, solo.numpy()[0], r.logits,
                          _chain(0, len(r.tokens))) == 0
