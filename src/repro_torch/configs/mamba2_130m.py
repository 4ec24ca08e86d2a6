"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

Every layer is a Mamba-2 block with no separate MLP; decode carries an
O(1) recurrent state per request (a conv tail and a (H, N, P) SSM
state), so the fixed-slot engine serves it.  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50_280, head_dim=64,
    ssm=SSMConfig(d_state=128, conv_width=4, expand=2, head_dim=64, n_groups=1),
    tie_embeddings=True, subquadratic=True,
)
