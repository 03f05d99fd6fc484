"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality), 48 layers,
ssm_state=128, tied embeddings.  [arXiv:2405.21060]
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba import SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,               # SSD heads = d_inner / head_dim (bookkeeping)
    n_kv_heads=64,
    d_head=64,
    d_ff=0,                   # no MLP: Mamba2 blocks only
    vocab=50304,              # 50280 padded to a multiple of 128
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=64),
    tie_embeddings=True,
    sub_quadratic=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=8, d_head=16,
        vocab=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=8),
        dtype="float32",
    )
