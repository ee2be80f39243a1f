"""Decoder-only LM, dense, SSM, MoE and hybrid families (and the VLM
family's backbone, ``models.multimodal``): the port of
``repro.models.transformer``.

The reference scans stacked per-layer params over segments of one block
kind; here each segment is a ``ModuleList`` walked in Python, and the cache
holds one list of per-layer dicts per segment: (k, v, pos) for a GQA block,
(c_kv, k_rope, pos) for an MLA block, (state, conv, pos) for a Mamba-2
block.  The segments are the reference's (``_segments``): ``blocks`` for
the dense, SSM and hybrid families; ``blocks_dense`` (attention + SwiGLU)
then ``blocks`` (attention + MoE) for the MoE family, whose router aux
losses add up.  The hybrid family (zamba2) runs its Mamba-2 ``blocks`` in
``n_layers // hybrid_attn_every`` groups, each followed by the one
``shared_attn`` block (attention + SwiGLU, a single weight copy) with that
group's own GQA cache (``cache["shared_attn"][group]``).  Attribute names
follow the reference params tree (``embed.embedding``,
``final_norm.scale``, ``blocks.<i>.attn.wq.w``, ``blocks_dense.<i>.mlp.up.w``,
``blocks.<i>.moe.gate``, ``shared_attn.attn.wq.w`` ...), which
``convert.from_jax_params`` relies on.

A config with ``mtp_depth`` (deepseek-v3) carries the reference's
multi-token-prediction block as ``mtp``, a ``DenseBlock``, so the reference
tree loads whole.  As in the reference's ``forward`` and ``decode_step``,
nothing on the serving path reads it; ``loss_fn`` does (ROADMAP.md queue
1, item 8): the block predicts token t + 2 from the embeddings, and its
cross-entropy adds at weight 0.1.

Training (``loss_fn`` under grad mode) wraps each block's apply in
``layers.remat`` when ``cfg.remat``, the reference's per-block
``jax.checkpoint``; an MoE block takes the capacity route with its Switch
aux loss.  Training runs the plain routes: the kernels have no backward
and refuse tensors that require grad (``kernels.ops``).

Public API: ``Transformer``, ``forward``, ``loss_fn``, ``init_cache``,
``decode_step`` (``decode_hidden`` then ``head_logits``), ``plan_requests``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .attention import (GQA, MLA, gqa_apply, gqa_cache_init, mla_apply,
                        mla_cache_init)
from .layers import (Dense, Embedding, RMSNorm, SlotStep, SwiGLU,
                     cross_entropy, dense, embed, local_map, remat, rmsnorm,
                     slot_step, swiglu, unembed)
from .moe import MoE, moe_apply
from .ssm import Mamba2, mamba2_apply, mamba2_cache_init


def _attn_apply(p, cfg, x, positions, cache, slots):
    fn = mla_apply if cfg.mla else gqa_apply
    return fn(p, cfg, x, positions=positions, cache=cache, slots=slots)


class DenseBlock(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, dtype)
        self.attn = (MLA if cfg.mla else GQA)(cfg, dtype)
        self.norm2 = RMSNorm(cfg.d_model, dtype)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype)


def dense_block_apply(p: DenseBlock, cfg, x: torch.Tensor,
                      positions: torch.Tensor, cache: Optional[Dict] = None,
                      slots: Optional[SlotStep] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    h, new_cache = _attn_apply(p.attn, cfg,
                               rmsnorm(p.norm1, x, cfg.norm_eps), positions,
                               cache, slots)
    x = x + h
    x = x + swiglu(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps))
    return x, None, new_cache


class MoEBlock(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, dtype)
        self.attn = (MLA if cfg.mla else GQA)(cfg, dtype)
        self.norm2 = RMSNorm(cfg.d_model, dtype)
        self.moe = MoE(cfg, dtype)


def moe_block_apply(p: MoEBlock, cfg, x: torch.Tensor,
                    positions: torch.Tensor, cache: Optional[Dict] = None,
                    slots: Optional[SlotStep] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Attention + MoE.  A cached call is serving, so the MoE is dropless
    (the reference's ``dropless=cache is not None``)."""
    h, new_cache = _attn_apply(p.attn, cfg,
                               rmsnorm(p.norm1, x, cfg.norm_eps), positions,
                               cache, slots)
    x = x + h
    y, aux = moe_apply(p.moe, cfg, rmsnorm(p.norm2, x, cfg.norm_eps),
                       dropless=cache is not None)
    return x + y, aux, new_cache


class MambaBlock(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, dtype)
        self.mixer = Mamba2(cfg, dtype)


def mamba_block_apply(p: MambaBlock, cfg, x: torch.Tensor,
                      positions: torch.Tensor, cache: Optional[Dict] = None,
                      slots: Optional[SlotStep] = None
                      ) -> Tuple[torch.Tensor, None, Optional[Dict]]:
    h, new_cache = mamba2_apply(p.mixer, cfg, rmsnorm(p.norm, x, cfg.norm_eps),
                                cache=cache, slots=slots)
    return x + h, None, new_cache


# block kind -> (block parameters, block apply -> (x, aux or None, cache))
_BLOCKS = {"dense": (DenseBlock, dense_block_apply),
           "moe": (MoEBlock, moe_block_apply),
           "mamba": (MambaBlock, mamba_block_apply)}


def _segments(cfg) -> List[Tuple[str, str, int]]:
    """(name, block kind, layers) of the decoder stack, in order: the
    reference's ``_segments``."""
    if cfg.family == "moe":
        nd = cfg.moe.n_dense_layers
        segs = [("blocks_dense", "dense", nd)] if nd else []
        return segs + [("blocks", "moe", cfg.n_layers - nd)]
    if cfg.family in ("ssm", "hybrid"):    # hybrid: + shared_attn, below
        return [("blocks", "mamba", cfg.n_layers)]
    return [("blocks", "dense", cfg.n_layers)]


def _hybrid_groups(cfg) -> int:
    """Groups of Mamba-2 blocks a hybrid stack runs, each followed by the
    shared block; 0 where the config has no shared block."""
    if cfg.family != "hybrid" or not cfg.hybrid_attn_every:
        return 0
    return cfg.n_layers // cfg.hybrid_attn_every


class Transformer(nn.Module):
    """Parameters of a decoder-only LM (the reference's params tree)."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype)
        self.final_norm = RMSNorm(cfg.d_model, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, dtype=dtype)
        for name, kind, n in _segments(cfg):
            block = _BLOCKS[kind][0]
            setattr(self, name, nn.ModuleList(block(cfg, dtype)
                                              for _ in range(n)))
        if cfg.family == "hybrid":
            self.shared_attn = DenseBlock(cfg, dtype)
        if cfg.mtp_depth:
            self.mtp = DenseBlock(cfg, dtype)


def _run_block(cfg, apply, block, x, positions, cache, slots):
    """One block's apply; without a cache under ``layers.remat`` (the
    reference checkpoints only its cache-less scan body)."""
    if cache is None:
        return remat(cfg, apply, block, cfg, x, positions)
    return apply(block, cfg, x, positions, cache, slots)


def _backbone(cfg, model: Transformer, x: torch.Tensor,
              positions: torch.Tensor, caches: Optional[Dict] = None,
              slots: Optional[SlotStep] = None):
    """Embedded input -> final hidden states.  ``slots``: a per-slot decode
    step's write and masks, shared by every layer.  Returns (x, summed aux
    loss, new_caches)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, List[Dict]] = {}
    n_groups = _hybrid_groups(cfg)
    if n_groups:
        # the reference's hybrid branch: each group's Mamba-2 blocks, then
        # the shared block with the group's own cache (with no cache it
        # runs between groups all the same)
        g = cfg.hybrid_attn_every
        blocks, shared = [], []
        for gi in range(n_groups):
            for i in range(gi * g, (gi + 1) * g):
                x, _, nc = _run_block(
                    cfg, mamba_block_apply, model.blocks[i], x, positions,
                    caches["blocks"][i] if caches is not None else None,
                    slots)
                blocks.append(nc)
            x, _, nc = _run_block(
                cfg, dense_block_apply, model.shared_attn, x, positions,
                caches["shared_attn"][gi] if caches is not None else None,
                slots)
            shared.append(nc)
        if caches is None:
            return x, aux_total, None
        return x, aux_total, {"blocks": blocks, "shared_attn": shared}
    for name, kind, _ in _segments(cfg):
        apply = _BLOCKS[kind][1]
        layers: List[Dict] = []
        for i, block in enumerate(getattr(model, name)):
            x, aux, nc = _run_block(cfg, apply, block, x, positions,
                                    caches[name][i] if caches is not None
                                    else None, slots)
            if aux is not None:
                aux_total = aux_total + aux
            layers.append(nc)
        new_caches[name] = layers
    return x, aux_total, (new_caches if caches is not None else None)


def head_logits(cfg, model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head over hidden states x (B, S, d): fp32
    logits (B, S, V)."""
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(model.embed, x)
    return dense(model.lm_head, x.float())


def forward(cfg, model: Transformer, tokens: torch.Tensor, *,
            input_embeds: Optional[torch.Tensor] = None,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32, aux loss: the MoE layers'
    router losses summed, 0 for other families).  ``input_embeds`` (B, P,
    d), a VLM's projected patches, go in front of the token embeddings
    (logits then cover P + S positions).  ``last_only`` projects only the
    final position, as serving prefill needs."""
    x = embed(model.embed, tokens, cfg.activation_dtype)
    if input_embeds is not None:
        x = torch.cat([input_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux, _ = _backbone(cfg, model, x, positions)
    if last_only:
        x = x[:, -1:]
    return head_logits(cfg, model, x), aux


def loss_fn(cfg, model: Transformer, batch: Dict) -> torch.Tensor:
    """batch: dict(tokens (B, S), labels (B, S)[, input_embeds (B, P, d)])
    -> scalar loss: the mean cross-entropy, the MoE layers' aux loss, and
    with ``mtp_depth`` 0.1 x the MTP block's loss on the labels two ahead.
    A VLM's prefix positions carry label -100."""
    embeds = batch.get("input_embeds")
    logits, aux = forward(cfg, model, batch["tokens"], input_embeds=embeds)
    labels = batch["labels"]
    if embeds is not None:
        pad = torch.full(embeds.shape[:2], -100, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss = cross_entropy(logits, labels)
    if cfg.mtp_depth:
        x = embed(model.embed, batch["tokens"], cfg.activation_dtype)
        positions = torch.arange(x.shape[1], device=x.device)
        h, _, _ = dense_block_apply(model.mtp, cfg, x, positions)
        # the labels two ahead, per batch row (each rank its own rows)
        l2 = local_map(lambda lb: torch.nn.functional.pad(
            lb[:, 2:], (0, 2), value=-100), (batch["labels"],), ((0,),),
            (0,))
        loss = loss + 0.1 * cross_entropy(head_logits(cfg, model, h), l2)
    return loss + aux


def init_cache(cfg, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None,
               per_slot_pos: bool = False) -> Dict:
    """One cache per layer, in one list per segment, and for a hybrid stack
    one GQA cache per group of its shared block (``shared_attn``);
    ``max_len`` sizes the KV (or compressed MLA) cache of an attention
    block and nothing of an SSM block.  ``per_slot_pos=True`` builds the
    continuous-batching cache: every ``pos`` is an int32 (batch,) tensor on
    ``device``, so each row is a decode lane at its own depth."""
    def one(kind):
        if kind == "mamba":
            return mamba2_cache_init(cfg, batch, dtype, device, per_slot_pos)
        if cfg.mla:
            return mla_cache_init(cfg, batch, max_len, dtype, device,
                                  per_slot_pos)
        return gqa_cache_init(cfg, batch, max_len, dtype, device,
                              per_slot_pos)

    caches = {name: [one(kind) for _ in range(n)]
              for name, kind, n in _segments(cfg)}
    n_groups = _hybrid_groups(cfg)
    if n_groups:
        caches["shared_attn"] = [one("dense") for _ in range(n_groups)]
    return caches


def plan_requests(cfg, batch: int, max_len: int, *, dtype=None, policy=None,
                  cached: bool = False, cache_dtype=None):
    """Warmup descriptors for the kernels this config routes through the
    plan registry (``compiler.registry``), the reference's
    ``plan_requests``: one flash request per sequence bucket up to
    ``max_len`` for the pallas attention impl, one SSD scan request per
    bucket for the pallas SSM impl.  The ragged MoE grouped GEMM depends on
    the routing, so it is planned on first use.

    ``cached=True`` is the Engine's grid: flash requests only behind
    ``cfg.fresh_prefill_kernel``, scan requests with the final state, and
    the decode grid — one ``decode_attention`` request per pos bucket up to
    ``max_len`` (GQA only: MLA decode runs the absorbed path) and one
    ``ssd_decode`` request.  ``cache_dtype`` (the port's addition) is the
    cache's dtype where it is not the activations': decode attention's
    built pumps depend on it, so its requests carry it as ``kv_dtype``;
    the SSD decode step runs in the promotion of the two (its conv window
    joins the cached tail to the new token), so its request does too."""
    from repro_torch.compiler.registry import BucketPolicy
    policy = policy or BucketPolicy()
    dtype = dtype or cfg.dtype
    reqs = []

    wants_attn = cfg.attention_impl == "pallas" and (
        cfg.family in ("dense", "moe", "vlm")
        or (cfg.family == "hybrid" and cfg.hybrid_attn_every))
    prefill_attn = wants_attn and (not cached or cfg.fresh_prefill_kernel)
    if prefill_attn and cfg.mla:
        m = cfg.mla
        # mla_apply takes the kernel only when the head dims line up
        prefill_attn = m.nope_head_dim + m.rope_head_dim == m.v_head_dim
    if prefill_attn:
        if cfg.mla:
            h = hkv = cfg.n_heads
            d = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
        else:
            h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        for sb in policy.seq_grid(max_len):
            reqs.append(("flash_attention",
                         dict(b=batch, h=h, hkv=hkv, s=sb, t=sb, d=d,
                              causal=True, dtype=dtype)))
    if cached and wants_attn and not cfg.mla:
        kv = {"kv_dtype": str(cache_dtype).replace("torch.", "")} \
            if cache_dtype is not None else {}
        for tb in policy.seq_grid(max_len):
            reqs.append(("decode_attention",
                         dict(b=batch, h=cfg.n_heads, hkv=cfg.n_kv_heads,
                              t=tb, d=cfg.head_dim_, dtype=dtype, **kv)))

    if cfg.family in ("ssm", "hybrid") and cfg.ssm_impl == "pallas" \
            and cfg.ssm:
        s = cfg.ssm
        nh = s.expand * cfg.d_model // s.head_dim
        for lb in policy.seq_grid(max_len):
            reqs.append(("ssd_scan",
                         dict(b=batch, l=lb, h=nh, p=s.head_dim,
                              n=s.state_dim, chunk=s.chunk,
                              n_groups=s.n_groups, dtype=dtype,
                              final_state=cached)))
        if cached:
            step = dtype if cache_dtype is None else str(
                torch.promote_types(getattr(torch, dtype), cache_dtype)
            ).replace("torch.", "")
            reqs.append(("ssd_decode",
                         dict(b=batch, h=nh, p=s.head_dim, n=s.state_dim,
                              n_groups=s.n_groups, dtype=step)))
    return reqs


def _kv_length(cache: Dict) -> Optional[int]:
    """The slots of the model's KV (or compressed MLA) caches, all sized to
    one ``max_len``; None for a stack of SSM blocks alone."""
    for layers in cache.values():
        for c in layers:
            if "k" in c:
                return c["k"].shape[2]
            if "c_kv" in c:
                return c["c_kv"].shape[1]
    return None


def decode_step(cfg, model: Transformer, tokens: torch.Tensor, cache: Dict, *,
                last_only: bool = False) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, S) at the cache's position -> (logits (B, S, V), cache).
    S == 1 is a decode step and S > 1 a cached prefill.  An int ``pos``
    gives (S,) positions, a per-slot (B,) one (B, S) rows, and its cache
    write, masks and next ``pos`` are built here once for every layer
    (``layers.SlotStep``; every layer's new ``pos`` is that one tensor).
    ``last_only`` projects only the final position (the Engine's prefill
    reads no other); the reference always projects all S."""
    x, new_caches = decode_hidden(cfg, model, tokens, cache)
    if last_only:
        x = x[:, -1:]
    return head_logits(cfg, model, x), new_caches


def decode_hidden(cfg, model: Transformer, tokens: torch.Tensor,
                  cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """``decode_step`` up to the final norm: the backbone's hidden states
    (B, S, d) and the cache (``serve.prefill_graph`` captures this and
    projects the one position it needs)."""
    x = embed(model.embed, tokens, cfg.activation_dtype)
    pos = cache[_segments(cfg)[0][0]][0]["pos"]
    steps = torch.arange(tokens.shape[1], device=x.device)
    slots = None
    if isinstance(pos, torch.Tensor):
        positions = pos[:, None] + steps[None, :]
        slots = slot_step(pos, _kv_length(cache))
    else:
        positions = pos + steps
    x, _, new_caches = _backbone(cfg, model, x, positions, caches=cache,
                                 slots=slots)
    return x, new_caches
