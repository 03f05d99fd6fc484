"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 64 routed experts top-6
with 2 shared experts; dense FFN on the first layer.  [arXiv:2405.04434]
"""

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=192,               # qk_nope (128) + qk_rope (64)
    d_ff=10944,               # the dense first layer
    vocab=102400,
    moe=MoEConfig(
        n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2, first_dense=True
    ),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    rope_theta=1e4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=48,
        d_ff=256, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=2, first_dense=True),
        mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32),
        dtype="float32",
    )
