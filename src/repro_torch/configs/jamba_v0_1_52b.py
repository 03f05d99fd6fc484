"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE every 2nd
layer (16 experts, top-2).  [arXiv:2403.19887]

32 layers in 4 periods of 8: one attention layer per period (position 3),
Mamba elsewhere; odd layers carry the 16-expert MoE FFN.  Jamba's SSM uses
d_state=16, run through the Mamba2/SSD layer as in the JAX package.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba import SSMConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, moe_every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=64),
    attn_every=8,
    attn_offset=3,
    rope_theta=1e6,
    sub_quadratic=True,   # 1:7 attention dilution + SSM state: long_500k runs
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, moe_every=2),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=8),
        dtype="float32",
    )
