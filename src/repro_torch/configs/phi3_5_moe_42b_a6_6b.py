"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2, GQA (kv=8).
[hf:microsoft/Phi-3.5-MoE-instruct]
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=6400,
    vocab=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    rope_theta=1e4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
        dtype="float32",
    )
