"""gemma3-12b [dense] — 5:1 local:global attention, 256k vocab.

Local layers use a 1024-token sliding window, so 40 of the 48 layers
attend to at most 1024 keys.  [hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15_360, vocab_size=262_144, head_dim=256,
    sliding_window=1024, local_global_period=6,
    tie_embeddings=True, rope_theta=1_000_000.0,
    subquadratic=True,
)
