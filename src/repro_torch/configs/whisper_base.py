"""whisper-base [audio] — encoder-decoder transformer backbone; the conv
frontend is a stub (the model takes precomputed frame embeddings of
``frontend_dim`` in ``batch["audio"]``).  Fixed slots only: the encoder's
K/V of ``encoder_len`` frames per request has nothing to page.
[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51_865, head_dim=64,
    encoder_decoder=True, num_encoder_layers=6, encoder_len=1500,
    frontend="audio", frontend_len=1500, frontend_dim=80,
)
