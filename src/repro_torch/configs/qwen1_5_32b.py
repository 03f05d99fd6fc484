"""qwen1.5-32b [dense] — MHA (kv=40) with QKV bias.  [hf:Qwen/Qwen1.5-*]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_head=128,
    d_ff=27392,
    vocab=152064,
    attn_bias=True,
    rope_theta=1e6,
    flat_attn_proj=True,   # 40 heads ∤ 16-way model axis → flat (H·Dh) TP
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=512, dtype="float32",
    )
