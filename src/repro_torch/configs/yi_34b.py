"""yi-34b [dense] — llama-architecture GQA (kv=8).  [arXiv:2403.04652]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
    flat_attn_proj=True,   # 56 heads ∤ 16-way model axis → flat (H·Dh) TP
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512, dtype="float32",
    )
