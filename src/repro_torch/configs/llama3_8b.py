"""llama3-8b [dense] — GQA (kv=8), 128k vocab.  [arXiv:2407.21783]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=128256,
    rope_theta=5e5,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512, dtype="float32",
    )
