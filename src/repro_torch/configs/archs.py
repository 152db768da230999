"""The 10 assigned architectures (exact configs, sources in brackets) plus
reduced smoke variants (2 layers, d_model<=512, <=4 experts) used by the
per-arch CPU smoke tests (reference ``repro.configs.archs``, copied with
every ``source`` string as it is).  ``chip_smoke.py`` serves two FULL
configs, gemma3-1b and mamba2-1.3b, at their published widths.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoESpec, SSMSpec

# ---------------------------------------------------------------------------
# Full configs
# ---------------------------------------------------------------------------

GEMMA3_1B = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144, act="gelu", mlp_gated=True,
    sliding_window=1024, local_period=6,       # 5 local : 1 global
    rope_theta=1_000_000.0, tie_embeddings=True,
    source="[hf:google/gemma-3-1b-pt]",
)

JAMBA_1_5_LARGE = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536, act="silu",
    ssm=SSMSpec(d_state=128, expand=2, head_dim=128, conv_width=4, chunk=256),
    attn_period=8, attn_offset=4,              # 1 attn : 7 mamba
    moe=MoESpec(n_experts=16, top_k=2, d_expert=24576),
    moe_period=2, moe_offset=1,                # MoE every other layer
    tie_embeddings=False,
    source="[arXiv:2403.19887]",
)

MAMBA2_1_3B = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280,
    all_ssm=True,
    ssm=SSMSpec(d_state=128, expand=2, head_dim=64, conv_width=4, chunk=256),
    tie_embeddings=True,
    source="[arXiv:2405.21060]",
)

DEEPSEEK_MOE_16B = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=102400, act="silu",
    moe=MoESpec(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    moe_period=1, dense_ff_first=10944,        # layer 0 is a dense MLP
    tie_embeddings=False,
    source="[arXiv:2401.06066]",
)

SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206, act="gelu", mlp_gated=False,
    enc_layers=24,                             # speech encoder (stub frontend)
    tie_embeddings=True,
    source="[arXiv:2308.11596]",
)

GEMMA_2B = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="gelu", mlp_gated=True,  # GeGLU, MQA
    tie_embeddings=True,
    source="[arXiv:2403.08295]",
)

QWEN3_8B = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151936, act="silu", qk_norm=True,
    rope_theta=1_000_000.0, tie_embeddings=False,
    source="[hf:Qwen/Qwen3-8B]",
)

STARCODER2_7B = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152, act="gelu", mlp_gated=False, use_bias=True,
    rope_theta=1_000_000.0, tie_embeddings=True,
    source="[arXiv:2402.19173]",
)

LLAVA_NEXT_MISTRAL_7B = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, act="silu",
    prefix_len=2880,                           # anyres: up to 5 tiles x 576
    tie_embeddings=False,
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf]",
)

QWEN3_MOE_30B_A3B = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, act="silu", qk_norm=True,
    moe=MoESpec(n_experts=128, top_k=8, d_expert=768),
    moe_period=1, tie_embeddings=False,
    source="[hf:Qwen/Qwen3-30B-A3B]",
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        GEMMA3_1B, JAMBA_1_5_LARGE, MAMBA2_1_3B, DEEPSEEK_MOE_16B,
        SEAMLESS_M4T_LARGE_V2, GEMMA_2B, QWEN3_8B, STARCODER2_7B,
        LLAVA_NEXT_MISTRAL_7B, QWEN3_MOE_30B_A3B,
    ]
}


# ---------------------------------------------------------------------------
# Reduced smoke variants: same family/pattern, tiny dims
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    """2 layers (or one full period), d_model<=512, <=4 experts, small vocab."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        d_model=256, vocab=512,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        prefix_len=8 if cfg.prefix_len else 0,
    )
    if cfg.ssm is not None:
        kw["ssm"] = SSMSpec(d_state=16, expand=2, head_dim=32, conv_width=4, chunk=32)
    if cfg.moe is not None:
        kw["moe"] = MoESpec(n_experts=4, top_k=2,
                            d_expert=128, n_shared=min(cfg.moe.n_shared, 1))
    if cfg.attn_period > 0 and cfg.ssm is not None:
        kw["n_layers"] = cfg.attn_period          # one full hybrid period
        kw["attn_offset"] = cfg.attn_offset % cfg.attn_period
    elif cfg.local_period > 0:
        kw["n_layers"] = cfg.local_period
        kw["sliding_window"] = 16
    else:
        kw["n_layers"] = 2
    if cfg.dense_ff_first > 0:
        kw["dense_ff_first"] = 256
        kw["n_layers"] = 3                        # prelude + 2 moe layers
    if cfg.enc_layers > 0:
        kw["enc_layers"] = 2
        kw["n_layers"] = 2
    return cfg.replace(**kw)


SMOKE_ARCHS: dict[str, ModelConfig] = {name: reduced(c) for name, c in ARCHS.items()}
