"""phi-3-vision-4.2b [vlm] — phi3-mini backbone; the CLIP frontend is a
stub (the model takes precomputed patch embeddings of ``frontend_dim`` in
``batch["patches"]``, projected by ``frontend_proj`` over the first
``frontend_len`` token embeddings).  Fixed slots only, as in the
reference.  [hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32_064, head_dim=96,
    frontend="vision", frontend_len=256, frontend_dim=1024,
)
