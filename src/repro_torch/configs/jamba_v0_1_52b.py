"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every 2 layers.  One period of 8 layers: SSM blocks at positions 0-3 and
5-7, attention at position 4; the MLP is MoE on odd positions and dense
on even ones.  [arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14_336, vocab_size=65_536, head_dim=128,
    attn_period=8, attn_offset=4,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14_336,
                  moe_every=2, moe_offset=1),
    ssm=SSMConfig(d_state=16, conv_width=4, expand=2, head_dim=64, n_groups=1),
    subquadratic=True,
)
