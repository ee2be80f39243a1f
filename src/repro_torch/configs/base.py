"""Model configs: a jax-free mirror of ``repro.configs.base``.

Field names and defaults match the reference dataclasses, so a config
means the same in both packages.  Every reference config has its copy
here (dense, SSM, MoE, hybrid, enc-dec and VLM), served by this port's
model (``models.model``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

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


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


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
    remat: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        # every model layer tests kernel_plan == 'measure': a typo would
        # silently turn the registry off, so only the two policies pass
        if self.kernel_plan not in ("measure", "direct"):
            raise ValueError(f"kernel_plan must be 'measure' or 'direct', "
                             f"got {self.kernel_plan!r}")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _modname(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def load_arch(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_modname(arch_id)}")
    return mod.SMOKE if smoke else mod.CONFIG
