"""Family dispatcher: the single entry point the engine and launcher use.

Every family of the reference is ported: dense, SSM, MoE and hybrid
(``transformer``, with GQA or MLA attention), enc-dec (``encdec``) and VLM
(``multimodal``: the dense backbone behind a projector), dispatched as the
reference's ``models/model.py`` does.  ``loss_fn`` is the trainer's
entry point; ``example_batch`` the reference's seeded batch, drawn on the
port's threefry key chain (``serve.prng``) so that its tokens equal the
JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from . import encdec, multimodal, transformer


def _mod(cfg):
    if cfg.family == "encdec":
        return encdec
    if cfg.family == "vlm":
        return multimodal
    return transformer


def check_supported(cfg) -> None:
    if cfg.family not in ("dense", "ssm", "moe", "hybrid", "encdec", "vlm"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.family == "moe" and cfg.moe is None:
        raise ValueError(f"{cfg.name}: the moe family needs cfg.moe")
    if cfg.family in ("ssm", "hybrid") and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs cfg.ssm")


def build(cfg, dtype: torch.dtype = torch.float32) -> nn.Module:
    """Uninitialised parameters for ``cfg`` (see ``convert``)."""
    check_supported(cfg)
    if cfg.family == "encdec":
        return encdec.EncDec(cfg, dtype)
    if cfg.family == "vlm":
        return multimodal.VLM(cfg, dtype)
    return transformer.Transformer(cfg, dtype)


def loss_fn(cfg, model, batch: Dict) -> torch.Tensor:
    """batch: tokens and labels (B, S), with frames (encdec) or patches
    (vlm) -> the scalar training loss."""
    check_supported(cfg)
    return _mod(cfg).loss_fn(cfg, model, batch)


def example_batch(cfg, shape, key=None, batch_override: Optional[int] = None,
                  device=None) -> Dict[str, torch.Tensor]:
    """The reference's ``example_batch``: tokens uniform over the vocab
    from ``split(key)[0]``, labels the tokens shifted left with -100 last,
    frames or patches standard normal from ``split(key)[1]``; ``key``
    defaults to ``PRNGKey(0)``.  Tokens and labels are int64 (torch's index
    dtype), drawn on ``device`` (default the CPU)."""
    from repro_torch.serve import prng
    key = key if key is not None else prng.PRNGKey(0)
    b = batch_override or shape.global_batch
    k1, k2 = prng.split(key)
    tokens = prng.randint(k1, (b, shape.seq_len), 0, cfg.vocab_size, device)
    return lm_batch(cfg, tokens, k2)


def lm_batch(cfg, tokens: torch.Tensor, key) -> Dict[str, torch.Tensor]:
    """A training batch around ``tokens`` (B, S): int64 tokens, labels
    shifted left with -100 last, and for the stub frontends frames
    (encdec) or patches (vlm), standard normal draws from ``key`` on the
    tokens' device (the reference's ``example_batch`` and
    ``synthetic_batch`` both build theirs so)."""
    from repro_torch.serve import prng
    tokens = tokens.long()
    b, dev = tokens.shape[0], tokens.device
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -100
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = prng.normal(key, (b, cfg.encoder_seq, cfg.d_model),
                                      dev)
    if cfg.family == "vlm":
        batch["patches"] = prng.normal(
            key, (b, cfg.n_vision_tokens, cfg.d_vision), dev)
    return batch


def forward(cfg, model, batch: Dict, *, last_only: bool = False):
    """batch: tokens (B, S), with frames (encdec) or patches (vlm)."""
    check_supported(cfg)
    if cfg.family in ("encdec", "vlm"):
        return _mod(cfg).forward(cfg, model, batch, last_only=last_only)
    return transformer.forward(cfg, model, batch["tokens"],
                               last_only=last_only)


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None,
               per_slot_pos: bool = False):
    """``per_slot_pos=True``: the continuous-batching cache, a (batch,)
    int32 ``pos`` per layer (``serve.scheduler``); not for encdec."""
    check_supported(cfg)
    if per_slot_pos and cfg.family == "encdec":
        raise ValueError("per-slot cache positions (continuous batching) "
                         "are not supported for the encdec family")
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, dtype, device)
    return _mod(cfg).init_cache(cfg, batch, max_len, dtype, device,
                                per_slot_pos)


def decode_step(cfg, model, batch: Dict, cache, *, last_only: bool = False):
    """One cached step; batch carries tokens (B, S) (+ enc_out for
    encdec)."""
    check_supported(cfg)
    if cfg.family == "encdec":
        return encdec.decode_step(cfg, model, batch["tokens"],
                                  batch["enc_out"], cache,
                                  last_only=last_only)
    return _mod(cfg).decode_step(cfg, model, batch["tokens"], cache,
                                 last_only=last_only)
