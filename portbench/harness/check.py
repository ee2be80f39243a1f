"""What decides ``correct``: served tokens against the plain reference.

Once the window has closed, a sample of the requests it finished is drawn
from the seed, always with the one that served the most tokens in it,
until the sample holds the mix's token budget.  The reference runs once
over each sampled prompt followed by its served tokens, and at every
served position reads how far the served token's logit lies below the
reference's best there.  The widest of those gaps is compared with the
cell's limit (``limits/<workload>.json``).

The control puts the reference in the program's place, computed with its
weight matrices rounded to fp8 (e4m3, a scale per leaf): at each of the
same positions the token the control ranks first is read against the fp32
reference the same way.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from portbench.reference.common import widest_gaps

from .loop import Req
from .traffic import _seq


def sample(done: Sequence[Req], seed: int, n_req: int,
           n_tok: int) -> List[Req]:
    """The longest finished request, then others in an order drawn from
    the seed, until ``n_req`` requests or ``n_tok`` served tokens."""
    if not done:
        return []
    done = sorted(done, key=lambda r: r.rid)
    longest = max(done, key=lambda r: (len(r.tokens), -r.rid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(_seq(seed, 3)).permutation(len(rest))
    out, toks = [longest], len(longest.tokens)
    for i in order:
        if len(out) >= n_req or toks >= n_tok:
            break
        out.append(rest[i])
        toks += len(rest[i].tokens)
    return out


def _summary(gaps: List[torch.Tensor], n_req: int) -> Dict:
    """The widest gap, and beside it the mean gap and the share of served
    positions whose token is not the reference's best."""
    allg = torch.cat(gaps)
    return {"max_gap": float(allg.max()), "mean_gap": float(allg.mean()),
            "miss_share": float((allg > 0).float().mean()),
            "tokens": int(allg.numel()), "requests": n_req}


def _sequences(reqs: List[Req], device) -> tuple:
    seqs, starts = [], []
    for r in reqs:
        ids = np.concatenate([np.asarray(r.prompt, np.int64),
                              np.asarray(r.tokens[:-1], np.int64)])
        seqs.append(torch.as_tensor(ids, device=device))
        starts.append(r.prompt_len - 1)
    return seqs, starts


@torch.no_grad()
def served_gap(forward: Callable, port: Dict, weights, reqs: List[Req],
               device) -> Dict:
    """The widest gap of the served tokens under the reference."""
    seqs, starts = _sequences(reqs, device)
    logits = forward(port, weights, seqs, starts)
    return _summary([widest_gaps(lg, torch.as_tensor(r.tokens,
                                                      device=device))
                     for lg, r in zip(logits, reqs)], len(reqs))


@torch.no_grad()
def control_gap(forward: Callable, port: Dict, weights, low_weights,
                reqs: List[Req], device) -> Dict:
    """The widest gap, under the fp32 reference, of the tokens the control
    (the reference on fp8 weights) ranks first at the same positions."""
    seqs, starts = _sequences(reqs, device)
    ref = forward(port, weights, seqs, starts)
    low = forward(port, low_weights, seqs, starts)
    return _summary([widest_gaps(r, c.argmax(-1)) for r, c in zip(ref, low)],
                    len(reqs))
