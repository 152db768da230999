"""Architecture config schema + layer-pattern resolution.

Every assigned architecture is a ``ModelConfig``; ``layer_kinds(cfg)``
expands it into a per-layer sequence of sublayer descriptors consumed by the
decoder stack (models/lm.py).  Patterns are periodic so the stack can
loop over same-structure blocks, whose params are stacked on a leading
axis (reference ``repro.configs.base``; a copy: pure dataclasses).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0        # 0 -> d_model // n_heads
    act: str = "silu"
    mlp_gated: bool = True
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: float = 0.0

    # --- attention pattern: period of alternating local/global layers.
    # sliding_window > 0 with local_period p means layers i%p != p-1 are
    # local (windowed); the last layer in each period is global.
    sliding_window: int = 0
    local_period: int = 0

    # --- MoE: layers i with i % moe_period == moe_offset are MoE
    moe: Optional[MoESpec] = None
    moe_period: int = 1
    moe_offset: int = 0
    dense_ff_first: int = 0  # deepseek-moe: layer 0 uses a dense MLP this wide

    # --- SSM / hybrid: layers i with i % attn_period == attn_offset are
    # attention; the rest are SSM blocks (jamba 1:7 -> attn_period=8).
    ssm: Optional[SSMSpec] = None
    attn_period: int = 0     # 0 -> all attention; 1 -> all ssm handled below
    attn_offset: int = 0
    all_ssm: bool = False    # mamba2: no attention at all

    # --- encoder-decoder (audio) --------------------------------------
    enc_layers: int = 0      # >0 -> enc-dec; encoder consumes stub embeddings

    # --- multimodal stub prefix (vlm/audio frontends) ------------------
    prefix_len: int = 0      # patch/frame embeddings prepended to the text

    source: str = ""         # citation for the config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SubLayer:
    kind: str                 # 'attn' | 'ssm'
    window: int = 0           # 0 = full causal attention
    ffn: str = "mlp"          # 'mlp' | 'moe' | 'none'
    d_ff_override: int = 0


def layer_kinds(cfg: ModelConfig) -> list[SubLayer]:
    """Expand the config into one SubLayer per decoder layer."""
    out = []
    for i in range(cfg.n_layers):
        # mixer
        if cfg.all_ssm:
            kind, window = "ssm", 0
        elif cfg.attn_period > 0 and cfg.ssm is not None:
            if i % cfg.attn_period == cfg.attn_offset:
                kind, window = "attn", 0
            else:
                kind, window = "ssm", 0
        else:
            kind = "attn"
            window = 0
            if cfg.local_period > 0 and cfg.sliding_window > 0:
                if i % cfg.local_period != cfg.local_period - 1:
                    window = cfg.sliding_window
            elif cfg.sliding_window > 0:
                window = cfg.sliding_window
        # ffn
        if cfg.all_ssm:
            ffn = "none"  # mamba2 blocks have no separate FFN
            d_over = 0
        elif cfg.moe is not None and i % cfg.moe_period == cfg.moe_offset:
            if i == 0 and cfg.dense_ff_first > 0:
                ffn, d_over = "mlp", cfg.dense_ff_first
            else:
                ffn, d_over = "moe", 0
        else:
            ffn, d_over = "mlp", 0
        if i == 0 and cfg.dense_ff_first > 0 and ffn != "mlp":
            ffn, d_over = "mlp", cfg.dense_ff_first
        out.append(SubLayer(kind=kind, window=window, ffn=ffn, d_ff_override=d_over))
    return out


def pattern_period(cfg: ModelConfig) -> int:
    """Smallest period P such that layers i and i+P have identical SubLayer
    structure for all i >= first_regular (layer 0 may be special)."""
    kinds = layer_kinds(cfg)
    # find smallest p dividing the tail (after any special first layer) into
    # identical repeating blocks
    start = 1 if (cfg.dense_ff_first > 0) else 0
    tail = kinds[start:]
    m = len(tail)
    for p in range(1, m + 1):
        if m % p == 0 and all(tail[i] == tail[i % p] for i in range(m)):
            return p
    return m


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
