"""Model/architecture configuration for the assigned-architecture pool.

Every architecture in the pool is expressible as a ``ModelConfig``:
dense decoder, GQA/MHA, sliding-window attention, MoE FFN, Mamba2 SSD
blocks (pure or hybrid-with-shared-attention), cross-attention (VLM),
and encoder-decoder (audio). Modality frontends are stubs per the brief:
``input_specs`` provides precomputed patch/frame embeddings. (The port's
copy of ``repro/configs/base.py``.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads
    activation: str = "silu"  # "silu" | "gelu" | "relu2"
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # SWA width (tokens)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # mixture of experts (FFN replaced in every layer when set)
    moe: Optional[MoEConfig] = None

    # state-space blocks. ssm set + hybrid_attn_every=None => pure SSM stack.
    # hybrid_attn_every=k  => one *shared* attention+MLP block applied after
    # every k SSM blocks (Zamba2-style parameter sharing).
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: Optional[int] = None

    # VLM: a cross-attention layer after every (cross_attn_every-1) self-attn
    # layers; vision tokens come precomputed from the (stubbed) frontend.
    cross_attn_every: Optional[int] = None
    num_vision_tokens: int = 0

    # encoder-decoder (audio): encoder over precomputed frame embeddings.
    encoder_layers: int = 0
    num_frames: int = 0

    # numerics / execution
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True  # per-block activation checkpointing in training
    loss_chunk: int = 512  # sequence-chunked cross-entropy (memory bound)
    # the port's CUDA kernels (flash attention, SSD scan) on the card and
    # their plain versions on the CPU; the name is the reference's
    use_pallas: bool = False
    # Fully unroll layer/loss scans when lowering. Scanned loops compile
    # faster, but XLA's cost analysis counts a while body ONCE — unrolled
    # lowering gives trip-count-faithful FLOP/byte/collective numbers for the
    # roofline (launch/dryrun uses unroll for the single-pod roofline cells).
    scan_unroll: bool = False
    # Unroll the *inner* fixed-trip scans (chunked loss, SSD state recurrence)
    # whose trip counts don't vary with layer count — the probe-delta method
    # can't extrapolate those, so the dry-run unrolls them instead.
    inner_unroll: bool = False

    # ---- §Perf hillclimb variants (False == paper-faithful baseline) ----
    # Shard the embedding table on d_model instead of vocab: the gather then
    # has its indexed dim unsharded -> no involuntary replication of the
    # [B,S,D] lookup (XLA SPMD warning), no all-gather of the table.
    embed_dmodel_shard: bool = False
    # Shard-local MoE dispatch: route/sort/position per data shard (batched
    # ops, no cross-shard argsort), capacity-sharded dispatch buffers, and
    # expert weights with a TP fallback on d_ff when the expert count doesn't
    # divide the model axis (mixtral: 8 experts vs 16-wide TP).
    moe_shard_dispatch: bool = False
    # Attention score/weight buffers in bf16 (max-subtracted, f32 row sums):
    # halves the dominant O(S^2) bytes of the ref attention path.
    attn_scores_bf16: bool = False
    # Activation-checkpoint policy: "full" (recompute everything, paper-era
    # default), "dots" (save matmul outputs, recompute elementwise only),
    # "none" (no remat).
    remat_policy: str = "full"
    # MoE combine as scatter-from-experts + psum instead of gathering the
    # expert-sharded dispatch buffer (cuts combine collective bytes ~E/TP x).
    moe_psum_combine: bool = False
    # Cast params to the compute dtype ONCE per step (before FSDP gathers)
    # instead of per-use: the all-gather then moves bf16, not f32 — half the
    # parameter collective bytes.
    cast_params_once: bool = False

    # ---------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads

    @property
    def is_ssm(self) -> bool:
        return self.ssm is not None and self.hybrid_attn_every is None

    @property
    def is_hybrid(self) -> bool:
        return self.ssm is not None and self.hybrid_attn_every is not None

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_vlm(self) -> bool:
        return self.cross_attn_every is not None

    @property
    def sub_quadratic(self) -> bool:
        """Supports 500k-token decode without a full-context KV-cost blowup
        growing quadratically at prefill (SSM / hybrid / sliding-window)."""
        return self.ssm is not None or self.sliding_window is not None

    @property
    def supports_decode(self) -> bool:
        return True  # all pool members are (or contain) decoders

    def scan_groups(self) -> tuple[int, int]:
        """(num_scan_steps, layers_per_step) for the decoder stack."""
        if self.is_hybrid:
            k = self.hybrid_attn_every
            assert self.num_layers % k == 0, (self.num_layers, k)
            return self.num_layers // k, k
        if self.is_vlm:
            k = self.cross_attn_every
            assert self.num_layers % k == 0
            return self.num_layers // k, k
        return self.num_layers, 1

    def param_count(self) -> int:
        """Total parameters (for 6*N*D roofline accounting)."""
        from repro_torch.models.model import count_params  # lazy, avoids cycle

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params

        return count_params(self, active_only=True)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    groups, per = cfg.scan_groups()
    small_layers = per * min(2, groups)
    heads = min(cfg.num_heads, 4)
    q_per_kv = max(1, cfg.num_heads // cfg.num_kv_heads)
    kv = max(1, heads // min(q_per_kv, heads))
    base = dict(
        num_layers=small_layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        num_vision_tokens=16 if cfg.is_vlm else 0,
        encoder_layers=2 if cfg.is_enc_dec else 0,
        num_frames=24 if cfg.is_enc_dec else 0,
        sliding_window=16 if cfg.sliding_window else None,
        loss_chunk=32,
        remat=False,
    )
    if cfg.moe:
        base["moe"] = MoEConfig(
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            capacity_factor=cfg.moe.capacity_factor,
        )
    if cfg.ssm:
        base["ssm"] = SSMConfig(
            d_state=16, d_conv=cfg.ssm.d_conv, expand=2, head_dim=16, chunk=16
        )
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
