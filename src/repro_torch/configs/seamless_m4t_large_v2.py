"""seamless-m4t-large-v2 [audio] — encoder-decoder backbone (24+24 layers);
the speech frontend is a stub supplying precomputed frame embeddings.
[arXiv:2308.11596]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,              # decoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab=256256,            # 256206 padded to a multiple of 256 (TP-divisible)
    encdec=True,
    n_enc_layers=24,
    enc_seq=4096,             # encoder memory length for decode shapes
    rope_theta=1e4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_head=16, d_ff=128, vocab=512, enc_seq=32, dtype="float32",
    )
