"""qwen3-1.7b [dense] — qk-norm, GQA (kv=8), tied embeddings.  [hf:Qwen/Qwen3-*]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512, dtype="float32",
    )
