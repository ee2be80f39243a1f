"""The one traffic generator: reads a mix's parameters and deals a closed
loop's requests in the order its clients send them.

Every seed gets the same sizes in another order.  The pool's prompt and
output lengths are the distributions' quantiles at evenly spaced levels,
cut into ``STRATA`` bands of equal count; the requests are dealt in
rounds, each round one prompt from every prompt band and one output from
every output band, paired and ordered at random.  So any run of requests
sent holds nearly the same mix of sizes whatever the seed, and a window
of a few hundred requests sees the distribution, not a draw of it.  The
seed changes the order, the pairing and the prompt tokens.

A client's first request starts mid-answer (its output length cut to a
uniform share of the drawn one, at least 3 tokens), so the clients'
completions are spread from the first steps instead of arriving together.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np

# requests in the pool a seed deals from, and the bands its sizes are cut
# into: every run of STRATA requests sent holds one size from each band
POOL = 4096
STRATA = 16

@dataclass(frozen=True)
class Item:
    """One request of the pool: its prompt and output lengths."""
    idx: int
    prompt_len: int
    n_new: int


def _seq(seed: int, *more: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % (1 << 63), *more])


def quantiles(spec: Dict, n: int) -> List[int]:
    """``n`` lengths at the levels (i + 0.5) / n of the spec's distribution,
    rounded and clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    levels = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "uniform":
        vals = [lo + u * (hi - lo + 1) - 0.5 for u in levels]
    elif spec["dist"] == "lognormal":
        nd = NormalDist()
        mu, sig = math.log(spec["median"]), spec["sigma"]
        vals = [math.exp(mu + sig * nd.inv_cdf(u)) for u in levels]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(hi, max(lo, int(round(v)))) for v in vals]


class Traffic:
    """A mix dealt for one seed: ``first(client)`` gives a client's first
    request, ``next()`` the next request sent by any client, ``tokens(item)``
    a request's prompt."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        n, bands = POOL, STRATA
        per = n // bands
        prompts = quantiles(mix["prompt"], n)
        outputs = quantiles(mix["output"], n)
        if prompts[-1] + outputs[-1] > mix["max_len"]:
            raise ValueError("a request of the mix exceeds max_len")
        if outputs[0] < 3:
            raise ValueError("every request of the mix needs 3 tokens or more")
        rng = np.random.default_rng(_seq(seed, 1))

        def banded(vals):
            return [[vals[b * per + i] for i in rng.permutation(per)]
                    for b in range(bands)]

        pb, ob = banded(prompts), banded(outputs)
        self.items: List[Item] = []
        for r in range(per):
            for bp, bo in zip(rng.permutation(bands), rng.permutation(bands)):
                self.items.append(Item(len(self.items), pb[bp][r], ob[bo][r]))
        c = int(mix["clients"])
        # a client's first request keeps this share of its output
        self.first_share = rng.random(c)
        self.clients = c
        self._sent = 0

    def _take(self) -> Item:
        it = self.items[self._sent % len(self.items)]
        self._sent += 1
        return it

    def first(self, client: int) -> Item:
        it = self._take()
        cut = max(3, int(math.ceil(self.first_share[client] * it.n_new)))
        return Item(it.idx, it.prompt_len, cut)

    def next(self) -> Item:
        return self._take()

    def tokens(self, item: Item) -> np.ndarray:
        rng = np.random.default_rng(_seq(self.seed, 2, item.idx))
        return rng.integers(0, self.vocab, size=item.prompt_len,
                            dtype=np.int32)
