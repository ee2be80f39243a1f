"""Deterministic, checkpointable synthetic-token data stream: the port of
``repro.data.pipeline``.

A batch is a pure function of (seed, step): its key is ``fold_in(
PRNGKey(seed), step)`` on the port's threefry key chain
(``serve.prng``), so the port draws the JAX package's tokens bit for bit,
and a restart needs to save only the integer step (exactly-once batches
across restarts, ``runtime.failover``).  Each sequence repeats a random
n-gram (so a language model's loss can fall), 5 % of its tokens replaced
by uniform noise; labels are the tokens shifted left with -100 last.
Frames (enc-dec) and patches (VLM) are standard normal draws.  With pump
factor M every leaf is reshaped to (M, B / M, ...), M microbatches.

Batches are drawn on the trainer's device (the counters, the threefry
rounds and the selects run there; nothing crosses from the host but the
two key words).  Tokens and labels are int64, torch's index dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as model_mod
from repro_torch.serve import prng


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    # structured synthetic text: repeated n-grams so the LM loss can fall
    ngram: int = 8
    vocab_cap: int = 0           # 0 = model vocab


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, dcfg: DataConfig,
                    step: int, *, batch_override: Optional[int] = None,
                    pump_factor: int = 1, device=None
                    ) -> Dict[str, torch.Tensor]:
    """The batch for ``step``, on ``device`` (default the CPU)."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    vocab = dcfg.vocab_cap or cfg.vocab_size
    key = prng.fold_in(prng.PRNGKey(dcfg.seed), step)
    k1, k2, k3 = prng.split(key, 3)
    base = prng.randint(k1, (b, dcfg.ngram), 0, vocab, device)
    reps = -(-s // dcfg.ngram)
    tokens = base.repeat(1, reps)[:, :s]
    noise = prng.bernoulli(k2, 0.05, (b, s), device)
    rand = prng.randint(k3, (b, s), 0, vocab, device)
    batch = model_mod.lm_batch(cfg, torch.where(noise, rand, tokens), k2)
    if pump_factor > 1:
        batch = {k: a.reshape((pump_factor, b // pump_factor) + a.shape[1:])
                 for k, a in batch.items()}
    return batch


class DataIterator:
    """Stateful view over the stateless stream (tracks ``step`` for the
    checkpoint)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 dcfg: DataConfig = DataConfig(), start_step: int = 0,
                 batch_override: Optional[int] = None, pump_factor: int = 1,
                 device=None):
        self.cfg, self.shape, self.dcfg = cfg, shape, dcfg
        self.step = start_step
        self.batch_override = batch_override
        self.pump_factor = pump_factor
        self.device = device

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = synthetic_batch(self.cfg, self.shape, self.dcfg, self.step,
                            batch_override=self.batch_override,
                            pump_factor=self.pump_factor, device=self.device)
        self.step += 1
        return b

    def __iter__(self) -> Iterator:
        return self

    def state(self) -> dict:
        return {"step": self.step, "seed": self.dcfg.seed}

    @classmethod
    def from_state(cls, cfg, shape, state: dict, **kw) -> "DataIterator":
        return cls(cfg, shape, DataConfig(seed=state["seed"]),
                   start_step=state["step"], **kw)
