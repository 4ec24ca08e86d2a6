"""grok-1-314b [moe] — 8 experts top-2, the largest assigned cell.

[hf:xai-org/grok-1; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32_768, vocab_size=131_072, head_dim=128,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32_768),
)
