"""Typed model configuration of the LM families (counterpart of
:mod:`repro.configs.base`): every runtime-tunable quantity is a field.

``get_config(arch_id)`` loads ``repro_torch.configs.<arch_id>`` (dashes and
dots → underscores) and returns its ``CONFIG``; each arch module also
provides ``reduced()``, a small same-family config for CPU tests.  Every
family of :data:`ARCH_IDS` is ported: dense, ``moe`` (MLA comes with
deepseek's config), ``ssm`` (mamba2-1.3b), ``hybrid`` (jamba-v0.1-52b:
Mamba, attention and MoE layers), ``vlm`` (llama-3.2-vision-90b: a
cross-attention layer every ``cross_attn_every`` layers over
``n_media_tokens`` precomputed patch embeddings) and ``audio``
(seamless-m4t-large-v2: an encoder of ``n_enc_layers`` bidirectional
layers over precomputed frame embeddings, and a decoder whose every layer
cross-attends the encoded memory).
"""

from __future__ import annotations

import dataclasses
import importlib

from typing import Optional

import torch

from repro_torch.models.mamba import SSMConfig
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
    """The fields of :class:`repro.configs.base.ModelConfig` that the six
    families read, with the same names and defaults, the training's
    rematerialisation knobs (``remat``; ``remat_policy`` "full" or
    "dots") and ``scan_layers`` (on: a stack's repeated period stored
    stacked along a leading layer axis; off: every layer its own subtree
    under ``"prefix"``).  The JAX package's other execution knobs
    (attention tile sizes, unrolling: the card's kernels size their own
    tiles) have no counterpart."""
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
    ssm: Optional[SSMConfig] = None
    # hybrid schedule: attention layer once per `attn_every` layers
    attn_every: int = 1
    attn_offset: int = 3            # position of the attn layer in the period
    # vlm: one cross-attn layer per `cross_attn_every` layers
    cross_attn_every: int = 0
    n_media_tokens: int = 0
    # enc-dec (audio): n_layers is the decoder depth
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 4096             # the memory length a cache holds by default
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"      # "full" | "dots" (save the 2-D matmuls)
    scan_layers: bool = True
    sub_quadratic: bool = False     # arch supports long_500k decode

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


@dataclasses.dataclass(frozen=True)
class Shape:
    """A workload shape: ``global_batch`` sequences of ``seq_len`` tokens,
    to train, prefill or decode."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

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

# Archs whose family the port runs: all of them.
PORTED_ARCHS = ("qwen1.5-32b", "llama3-8b", "yi-34b", "qwen3-1.7b",
                "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b",
                "mamba2-1.3b", "jamba-v0.1-52b", "llama-3.2-vision-90b",
                "seamless-m4t-large-v2")


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def list_archs():
    return list(ARCH_IDS)
