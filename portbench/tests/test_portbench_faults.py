"""A run with the timed path broken underneath comes out not correct:
the harness past its look for a card, on the CPU at SMOKE widths, with
the cell's own limit.  One run per fault a serving cell can have (a
one-card cell has no exchange between chips to leave out), and a sound
run that passes."""
import json
import math
from pathlib import Path

import pytest
import torch

import small
from portbench import run as run_mod
from portbench.harness.cell import log

LIMITS = Path(__file__).resolve().parents[1] / "limits"
BENCH = {"end_to_end": [{"name": "tok_s", "unit": "tokens/s"}],
         "per_layer": []}


def _run(conf):
    lim = json.loads((LIMITS / f"{small.CELL[conf['reference']]}.json")
                     .read_text())["compare"]
    f = small.files(conf, compare=lim)
    return run_mod.run_cell(f, BENCH, 4242, 2.0, False, torch.device("cpu"),
                            0.0, log)


def _token_altered(mp):
    from repro_torch.serve.scheduler import Scheduler
    orig = Scheduler._host_rows

    def host_rows(self, logits, keys):
        toks, rows = orig(self, logits, keys)
        return [(t + 1) % logits.shape[-1] for t in toks], rows
    mp.setattr(Scheduler, "_host_rows", host_rows)


def _state_unchanged(mp):
    from repro_torch.serve import engine
    orig = engine.model_mod.decode_step

    def step(cfg, model, batch, cache, **kw):
        logits, new = orig(cfg, model, batch, cache, **kw)
        return logits, (cache if batch["tokens"].shape[1] == 1 else new)
    mp.setattr(engine.model_mod, "decode_step", step)


def _half_left_out(mp):
    from repro_torch.serve.engine import Engine
    orig = Engine.decode_token

    def decode(self, cache, tokens, enc_out=None):
        logits, new = orig(self, cache, tokens, enc_out)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0.0
        return logits, new
    mp.setattr(Engine, "decode_token", decode)


FAULTS = {"token_altered": _token_altered,
          "state_unchanged": _state_unchanged,
          "half_the_batch_left_out": _half_left_out}


@pytest.mark.parametrize("conf", [small.DENSE, small.SSM],
                         ids=lambda c: c["reference"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(conf, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(conf)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("conf", [small.DENSE, small.SSM],
                         ids=lambda c: c["reference"])
def test_sound_run_is_correct(conf):
    out = _run(conf)
    assert out["correct"] is True
    assert all(math.isfinite(c["value"]) for c in out["checks"].values())
    assert out["metrics"]["tok_s"]["value"] > 0
