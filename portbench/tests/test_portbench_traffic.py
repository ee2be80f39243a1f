"""The traffic generator: a seed repeats its draws, every seed gets the
same sizes, and no request exceeds the mix's cache."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench.harness.traffic import POOL, STRATA, Traffic, quantiles

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))


def _mix(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_seed_repeats(path):
    mix = _mix(path)
    a, b = Traffic(mix, 2 ** 31 + 17, 1000), Traffic(mix, 2 ** 31 + 17, 1000)
    for c in range(a.clients):
        assert a.first(c) == b.first(c)
    for _ in range(100):
        ia, ib = a.next(), b.next()
        assert ia == ib
        assert np.array_equal(a.tokens(ia), b.tokens(ib))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_sizes_every_seed(path):
    mix = _mix(path)
    sizes = [Counter((it.prompt_len, it.n_new) for it in
                     Traffic(mix, seed, 1000).items) for seed in (1, 99)]
    assert Counter(p for (p, _o) in sizes[0].elements()) == \
        Counter(p for (p, _o) in sizes[1].elements())
    assert Counter(o for (_p, o) in sizes[0].elements()) == \
        Counter(o for (_p, o) in sizes[1].elements())
    assert Traffic(mix, 1, 1000).items != Traffic(mix, 99, 1000).items


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_round_holds_every_band(path):
    """Each run of ``STRATA`` requests sent holds one prompt and one output
    from every band, whatever the seed."""
    mix = _mix(path)
    n, k = POOL, STRATA
    pq = quantiles(mix["prompt"], n)
    oq = quantiles(mix["output"], n)
    for seed in (3, 2 ** 32 + 5):
        tr = Traffic(mix, seed, 1000)
        for r in range(0, n, k):
            rnd = tr.items[r:r + k]
            assert sorted(pq.index(it.prompt_len) // (n // k) for it in rnd
                          if pq.count(it.prompt_len) == 1) == sorted(set(
                pq.index(it.prompt_len) // (n // k) for it in rnd
                if pq.count(it.prompt_len) == 1))
            assert abs(np.mean([it.prompt_len for it in rnd])
                       - np.mean(pq)) < 0.35 * np.mean(pq)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_requests_fit_and_first_ones_cut(path):
    mix = _mix(path)
    tr = Traffic(mix, 5, 1000)
    firsts = [tr.first(c) for c in range(tr.clients)]
    for it in firsts:
        full = tr.items[it.idx]
        assert 3 <= it.n_new <= full.n_new
    assert any(it.n_new < tr.items[it.idx].n_new for it in firsts)
    for it in tr.items:
        assert it.prompt_len + it.n_new <= mix["max_len"]
        assert mix["prompt"]["min"] <= it.prompt_len <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= it.n_new <= mix["output"]["max"]
    toks = tr.tokens(tr.items[0])
    assert toks.shape == (tr.items[0].prompt_len,)
    assert toks.min() >= 0 and toks.max() < 1000


def test_quantiles_by_hand():
    assert quantiles({"dist": "uniform", "min": 16, "max": 64}, 49) == \
        list(range(16, 65))
    med = quantiles({"dist": "lognormal", "median": 1536, "sigma": 0.6,
                     "min": 256, "max": 3968}, 101)
    assert med[50] == 1536 and med == sorted(med)
    assert med[0] >= 256 and med[-1] <= 3968
