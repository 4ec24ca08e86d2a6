"""minicpm-2b [dense] — WSD schedule, llama-like, MHA (kv=36).

[arXiv:2404.06395; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122_753, head_dim=64,
    tie_embeddings=True,
)
# WSD (warmup-stable-decay) learning-rate schedule is this arch's signature
# training feature — see repro_torch.optim.schedules.wsd_schedule.
SCHEDULE = "wsd"
