"""Model configs: a jax-free mirror of ``repro.configs.base``.

Field names and defaults match the reference dataclasses, so a config
means the same in both packages.  Three fields are the port's alone, each
defaulting to the reference's behaviour: ``MoEConfig.norm_topk_prob``
and ``ModelConfig.rope_scaling`` (YaRN, ``RopeScaling``), which serve
deepseek-v2-lite as published, and ``ModelConfig.prefill_graph_bucket``
(the prefill replayed as a CUDA graph, ``serve.prefill_graph``).  Every reference config has its copy
here (dense, SSM, MoE, hybrid, enc-dec and VLM), served by this port's
model (``models.model``).  ``param_count`` / ``active_param_count``,
``ShapeConfig``, ``SHAPES``, ``ARCH_IDS`` and ``cells`` are the
reference's, the trainer's sizing and the assigned (arch x shape) grid.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    d_expert: int = 0
    capacity_factor: float = 1.25
    inference_capacity_factor: float = 0.0
    router_aux_weight: float = 0.001
    n_dense_layers: int = 0
    # dropless serving (icf <= 0): the expert GEMMs as ragged grouped GEMMs
    # over row groups padded to 16 (csrc/grouped_gemm.cu on the card)
    # instead of the dense (E, t·k, d) einsum path
    ragged_dropless: bool = False
    # the port's: the top-k gates renormalised to sum to 1 (the reference's
    # behaviour) or, False, the router's softmax probabilities as they are
    # (DeepSeek-V2's published ``norm_topk_prob``)
    norm_topk_prob: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """YaRN rope scaling (arXiv:2309.00071), the seven keys of DeepSeek-V2's
    published ``rope_scaling``.  The rope dims' frequencies between the
    correction dims of ``beta_fast`` and ``beta_slow`` rotations over
    ``original_max_position_embeddings`` ramp from the base frequency to
    it over ``factor``; cos / sin are scaled by mscale(mscale) /
    mscale(mscale_all_dim) and an MLA softmax by mscale(mscale_all_dim)²,
    where mscale(m) = 0.1 m ln(factor) + 1."""
    type: str = "yarn"
    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    def __post_init__(self):
        if self.type != "yarn":
            raise ValueError(f"rope_scaling type {self.type!r}: only 'yarn' "
                             f"is supported")

    def _mscale(self, m: float) -> float:
        return 0.1 * m * math.log(self.factor) + 1.0 \
            if self.factor > 1 else 1.0

    def correction_range(self, dim: int, theta: float) -> Tuple[int, int]:
        """(low, high): the rope pair indices where the ramp from the base
        frequency (below low) to the scaled one (above high) starts and
        ends, clipped to [0, dim - 1]."""
        def at(rotations: float) -> float:
            return dim * math.log(self.original_max_position_embeddings
                                  / (rotations * 2 * math.pi)) \
                / (2 * math.log(theta))
        return (max(math.floor(at(self.beta_fast)), 0),
                min(math.ceil(at(self.beta_slow)), dim - 1))

    @property
    def rope_mscale(self) -> float:
        """The factor on cos and sin."""
        return self._mscale(self.mscale) / self._mscale(self.mscale_all_dim)

    @property
    def softmax_mscale(self) -> float:
        """The factor on an MLA softmax scale (1 without
        ``mscale_all_dim``)."""
        return self._mscale(self.mscale_all_dim) ** 2 \
            if self.mscale_all_dim else 1.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 64
    conv_width: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # the port's: YaRN rope scaling (a ``RopeScaling``, or its published
    # dict); None is plain RoPE, the reference's only form
    rope_scaling: Optional[RopeScaling] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0
    n_encoder_layers: int = 0
    encoder_seq: int = 1500
    n_vision_tokens: int = 0
    d_vision: int = 0
    mtp_depth: int = 0
    # 'xla_chunked': plain chunked attention in torch.  'pallas': the
    # hand-written CUDA kernels (csrc/) for fresh-cache prefill and decode;
    # the name is the reference's, so a config means the same in both.
    attention_impl: str = "xla_chunked"
    # 'xla': the plain chunked SSD in torch.  'pallas': the hand-written
    # CUDA SSD scan (every prefill) and SSD decode (every decode step)
    ssm_impl: str = "xla"
    # kernel-plan policy for the 'pallas' routes: 'measure' serves them
    # through the shape-bucketed plan registry (compiler.registry) at
    # measured pump factors; 'direct' calls kernels.ops at pump 1.  The
    # reference defaults to 'measure'; the port defaults to 'direct', so a
    # config keeps the route it had before the registry was ported
    kernel_plan: str = "direct"
    # route cache prefill (s > 1) through the flash kernel; valid only when
    # every prefill starts on a fresh cache (pos == 0).  The Engine sets it.
    fresh_prefill_kernel: bool = False
    prefill_continuation: bool = False
    attn_block_kv: int = 1024          # KV chunk for chunked attention
    # the port's: the CUDA-graph prefill's length bucket (tokens).  On the
    # card a fresh prefill of S tokens replays the graph captured at S
    # rounded up to a multiple of it (``serve.prefill_graph``); 0 runs
    # every prefill eagerly, the reference's only form
    prefill_graph_bucket: int = 0
    remat: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        # every model layer tests kernel_plan == 'measure': a typo would
        # silently turn the registry off, so only the two policies pass
        if self.kernel_plan not in ("measure", "direct"):
            raise ValueError(f"kernel_plan must be 'measure' or 'direct', "
                             f"got {self.kernel_plan!r}")
        if isinstance(self.rope_scaling, dict):
            # a configuration file's published dict
            object.__setattr__(self, "rope_scaling",
                               RopeScaling(**self.rope_scaling))

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Analytic parameter count (the reference's; the trainer's
        ``resolve_pump`` sizes the gradient by it)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.head_dim_
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "encdec", "vlm", "hybrid"):
            if self.mla:
                m = self.mla
                q = d * (self.n_heads * (m.nope_head_dim + m.rope_head_dim)) \
                    if not m.q_lora_rank else \
                    d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                        m.nope_head_dim + m.rope_head_dim)
                kv = d * (m.kv_lora_rank + m.rope_head_dim) \
                    + m.kv_lora_rank * self.n_heads * (
                        m.nope_head_dim + m.v_head_dim)
                o = self.n_heads * m.v_head_dim * d
                attn = q + kv + o
            else:
                attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            per_layer += attn
        ffn_dense = 3 * d * self.d_ff
        if self.family == "moe" and self.moe:
            mo = self.moe
            ffn_moe = 3 * d * mo.d_expert * (
                mo.n_experts + mo.n_shared_experts) + d * mo.n_experts
            n_moe = L - mo.n_dense_layers
            total_ffn = mo.n_dense_layers * ffn_dense + n_moe * ffn_moe
            return emb + L * per_layer + total_ffn
        if self.family in ("ssm", "hybrid") and self.ssm:
            s = self.ssm
            d_in = s.expand * d
            n_h = d_in // s.head_dim
            ssm_layer = (d * (2 * d_in + 2 * s.n_groups * s.state_dim + n_h)
                         + d_in * d + s.conv_width * (
                             d_in + 2 * s.n_groups * s.state_dim))
            if self.family == "ssm":
                return emb + L * ssm_layer
            # hybrid: the shared attention + SwiGLU block counted once
            return emb + L * ssm_layer + per_layer + ffn_dense
        return emb + L * (per_layer + ffn_dense)

    def active_param_count(self) -> int:
        """Parameters a token uses (MoE: only the routed top-k)."""
        if self.family != "moe" or not self.moe:
            return self.param_count()
        mo = self.moe
        inactive = 3 * self.d_model * mo.d_expert * (mo.n_experts - mo.top_k) \
            * (self.n_layers - mo.n_dense_layers)
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs for which long_500k is skipped (pure full-attention)
FULL_ATTENTION_ARCHS = {
    "deepseek-v3-671b", "deepseek-v2-lite-16b", "whisper-base",
    "granite-3-2b", "qwen2.5-14b", "qwen2-7b", "qwen3-0.6b", "internvl2-2b",
}

ARCH_IDS = [
    "mamba2-1.3b", "deepseek-v3-671b", "deepseek-v2-lite-16b", "whisper-base",
    "granite-3-2b", "qwen2.5-14b", "qwen2-7b", "qwen3-0.6b", "internvl2-2b",
    "zamba2-2.7b",
]


def _modname(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def load_arch(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_modname(arch_id)}")
    return mod.SMOKE if smoke else mod.CONFIG


def cells(include_skipped: bool = False):
    """All assigned (arch x shape) cells, the reference's grid."""
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            skip = shape.name == "long_500k" and arch in FULL_ATTENTION_ARCHS
            if skip and not include_skipped:
                continue
            out.append((arch, shape.name))
    return out
