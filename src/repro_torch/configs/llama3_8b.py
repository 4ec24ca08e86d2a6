"""llama3-8b [dense] — GQA kv=8, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14_336, vocab_size=128_256, head_dim=128,
    rope_theta=500_000.0,
)
