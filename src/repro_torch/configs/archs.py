"""The 10 assigned architectures, exact dims from the brief.

The port's copy of ``repro/configs/archs.py``; ``--arch <id>`` resolves
through this registry.
"""

from __future__ import annotations

from .base import ModelConfig, MoEConfig, SSMConfig

# [hf:HuggingFaceTB/SmolLM-135M] llama-arch small; GQA 9H/kv3
SMOLLM_135M = ModelConfig(
    name="smollm-135m",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152, head_dim=64,
    activation="silu", rope_theta=1e4, tie_embeddings=True,
)

# [arXiv:2402.16819] GQA, squared-ReLU MLP
NEMOTRON_4_340B = ModelConfig(
    name="nemotron-4-340b",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, head_dim=192,
    activation="relu2", rope_theta=1e4,
)

# [hf:mistralai/Mistral-Large-Instruct-2407]
MISTRAL_LARGE_123B = ModelConfig(
    name="mistral-large-123b",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    activation="silu", rope_theta=1e6,
)

# [arXiv:2407.10671] GQA with QKV bias
QWEN2_7B = ModelConfig(
    name="qwen2-7b",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    activation="silu", qkv_bias=True, rope_theta=1e6,
)

# [hf:meta-llama/Llama-3.2-11B-Vision] cross-attn image layers every 5th
LLAMA_32_VISION_11B = ModelConfig(
    name="llama-3.2-vision-11b",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    activation="silu", rope_theta=5e5,
    cross_attn_every=5, num_vision_tokens=1601,
)

# [arXiv:2411.15242] Mamba2 backbone + shared attention block
ZAMBA2_7B = ModelConfig(
    name="zamba2-7b",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    activation="gelu", rope_theta=1e4,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid_attn_every=3,  # 27 scan groups x (3 mamba blocks + shared attn)
)

# [arXiv:2401.04088] 8 experts top-2, sliding-window attention
MIXTRAL_8X22B = ModelConfig(
    name="mixtral-8x22b",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    activation="silu", rope_theta=1e6, sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
)

# [hf:Qwen/Qwen3-30B-A3B] 128 experts top-8
QWEN3_MOE_30B_A3B = ModelConfig(
    name="qwen3-moe-30b-a3b",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    activation="silu", rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
)

# [arXiv:2405.21060] pure SSD (state-space duality), attention-free
MAMBA2_1_3B = ModelConfig(
    name="mamba2-1.3b",
    num_layers=48, d_model=2048, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
)

# [arXiv:2308.11596] encoder-decoder over audio frames (frontend stubbed)
SEAMLESS_M4T_MEDIUM = ModelConfig(
    name="seamless-m4t-medium",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    activation="gelu", rope_theta=1e4,
    encoder_layers=12, num_frames=960,
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        SMOLLM_135M, NEMOTRON_4_340B, MISTRAL_LARGE_123B, QWEN2_7B,
        LLAMA_32_VISION_11B, ZAMBA2_7B, MIXTRAL_8X22B, QWEN3_MOE_30B_A3B,
        MAMBA2_1_3B, SEAMLESS_M4T_MEDIUM,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
