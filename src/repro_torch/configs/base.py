"""Typed model configuration of the LM families (counterpart of
:mod:`repro.configs.base`): every runtime-tunable quantity is a field.

``get_config(arch_id)`` loads ``repro_torch.configs.<arch_id>`` (dashes and
dots → underscores) and returns its ``CONFIG``; each arch module also
provides ``reduced()``, a small same-family config for CPU tests.  The
dense and the ``moe`` families are ported (MLA comes with deepseek's
``moe`` config); the other archs of :data:`ARCH_IDS` raise
``NotImplementedError`` (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
import importlib

from typing import Optional

import torch

from repro_torch.models.moe import MoEConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention's widths (DeepSeek-V2): the compressed
    key-value rank, the per-head q/k width without and with rope, and the
    value width."""
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of :class:`repro.configs.base.ModelConfig` that the dense
    and ``moe`` families read, with the same names and defaults, and the
    training's rematerialisation knobs (``remat``; ``remat_policy`` "full"
    or "dots").  The other families' fields (state space, hybrid schedule,
    cross-attention, encoder) and the JAX package's other execution knobs
    (attention tile sizes, scan-over-layers, unrolling: the card's kernels
    size their own tiles and the port runs a loop) come with the families
    that use them."""
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    attn_bias: bool = False
    flat_attn_proj: bool = False    # store QKV/O projections flattened (H·Dh)
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"      # "full" | "dots" (save the 2-D matmuls)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        from repro_torch.models.transformer import count_params

        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token runs through: each MoE layer's routed expert
        leaves counted at ``top_k / n_experts`` of their size."""
        from repro_torch.models.transformer import count_params

        return count_params(self, active_only=True)


ARCH_IDS = [
    "jamba-v0.1-52b",
    "qwen1.5-32b",
    "llama3-8b",
    "yi-34b",
    "qwen3-1.7b",
    "deepseek-v2-lite-16b",
    "phi3.5-moe-42b-a6.6b",
    "llama-3.2-vision-90b",
    "mamba2-1.3b",
    "seamless-m4t-large-v2",
]

# Archs whose family the port runs (dense and moe).
PORTED_ARCHS = ("qwen1.5-32b", "llama3-8b", "yi-34b", "qwen3-1.7b",
                "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b")


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED_ARCHS:
        raise NotImplementedError(
            f"{arch}: its family is not ported yet (ROADMAP A8); the port "
            f"runs {list(PORTED_ARCHS)}"
        )
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def list_archs():
    return list(ARCH_IDS)
