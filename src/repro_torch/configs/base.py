"""Model / run configuration dataclasses (the port's own copy).

One ``ModelConfig`` describes a full architecture; ``ShapeConfig`` describes
one assigned (seq_len, global_batch, kind) cell.  A field-for-field copy of
``repro.configs.base``: the port imports nothing of the JAX package, so the
dataclasses live here too.  The architectures ported so far instantiate
them in ``repro_torch/configs/<id>.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0            # total shared-expert hidden dim
    moe_every: int = 1              # MoE MLP every Nth layer (others dense)
    moe_offset: int = 0             # first MoE layer index within the period
    router_jitter: float = 0.0
    capacity_factor: float = 1.25   # capacity-impl slots = cf·T·k/E


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""
    d_state: int
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256           # SSD chunk length for training/prefill


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // num_heads
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    local_global_period: Optional[int] = None  # e.g. 6 => 5 local : 1 global
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Hybrid (jamba): attention layer every `attn_period` layers at
    # `attn_offset`; all other layers are SSM blocks.
    attn_period: Optional[int] = None
    attn_offset: int = 0
    # Encoder-decoder (whisper)
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_len: int = 0            # fixed encoder sequence length (frames)
    # Modality frontend stub: 'audio' | 'vision' | None.  The frontend itself
    # is a stub per the assignment brief — input_specs() provides precomputed
    # frame/patch embeddings.
    frontend: Optional[str] = None
    frontend_len: int = 0           # frames (audio) or patches (vision)
    frontend_dim: int = 0           # embedding dim supplied by the stub
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # True when *every* layer is sub-quadratic (SSM) or the arch has a
    # sliding-window majority — used to decide long_500k applicability.
    subquadratic: bool = False
    # Pad attention heads up to a TP-divisible count (e.g. minicpm's 36
    # heads -> 48 on a 16-wide model axis).  Padded heads are hard-masked
    # to zero output so the function is EXACTLY the unpadded model; the
    # win is 16-way sharding of attention instead of full replication.
    pad_heads_to: Optional[int] = None

    @property
    def padded_heads(self) -> int:
        return self.pad_heads_to or self.num_heads

    @property
    def padded_kv_heads(self) -> int:
        if self.pad_heads_to is None or self.num_kv_heads == 0:
            return self.num_kv_heads
        group = self.num_heads // self.num_kv_heads
        return self.padded_heads // group

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind ('attn' | 'attn_local' | 'ssm') for one period."""
        period = self.scan_period()
        kinds = []
        for i in range(period):
            if self.family in ("ssm",):
                kinds.append("ssm")
            elif self.attn_period:  # hybrid
                kinds.append("attn" if i % self.attn_period == self.attn_offset else "ssm")
            elif self.local_global_period:
                # gemma3 style: (period-1) local then 1 global
                kinds.append("attn" if (i + 1) % self.local_global_period == 0 else "attn_local")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def mlp_kinds(self) -> Tuple[str, ...]:
        """Per-layer MLP kind ('dense' | 'moe') for one period."""
        period = self.scan_period()
        kinds = []
        for i in range(period):
            if self.moe is not None and i % self.moe.moe_every == self.moe.moe_offset % self.moe.moe_every:
                kinds.append("moe")
            elif self.family == "ssm":
                kinds.append("none")  # mamba2 blocks have no separate MLP
            else:
                kinds.append("dense")
        return tuple(kinds)

    def scan_period(self) -> int:
        """Length of the repeating layer block that lax.scan iterates over."""
        period = 1
        if self.attn_period:
            period = self.attn_period
        if self.local_global_period:
            period = max(period, self.local_global_period)
        if self.moe is not None and self.moe.moe_every > 1:
            import math
            period = period * self.moe.moe_every // math.gcd(period, self.moe.moe_every)
        assert self.num_layers % period == 0, (self.name, self.num_layers, period)
        return period


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shapes (identical for every assigned architecture).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A small same-family config for CPU smoke tests."""
    period = cfg.scan_period()
    small = dict(
        num_layers=2 * period,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads else 4,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        sliding_window=32 if cfg.sliding_window else None,
        encoder_len=cfg.encoder_len and 32,
        num_encoder_layers=cfg.num_encoder_layers and 2,
        frontend_len=cfg.frontend_len and 8,
        frontend_dim=cfg.frontend_dim and 64,
    )
    if cfg.moe is not None:
        # capacity_factor = num_experts => no capacity drops: smoke tests
        # assert exact prefill/decode consistency (production keeps 1.25)
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32,
            d_ff_shared=64 if cfg.moe.d_ff_shared else 0, capacity_factor=4.0)
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=16)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
