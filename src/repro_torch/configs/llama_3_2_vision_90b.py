"""llama-3.2-vision-90b [vlm] — 100-layer text backbone with a
cross-attention layer every 5th layer attending precomputed patch
embeddings (the vision frontend is a stub).  The published model gates
its cross-attention; the JAX package's code has no gate, and the port
follows the code.  [hf:meta-llama/Llama-3.2-90B-Vision]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=5,
    n_media_tokens=1600,      # ~one tile of patch embeddings
    rope_theta=5e5,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512, cross_attn_every=5, n_media_tokens=16,
        dtype="float32",
    )
