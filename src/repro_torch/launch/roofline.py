"""Three-term roofline of one step on one NVIDIA H100 (reference
``repro.launch.roofline``).

Hardware model: NVIDIA's H100 SXM data sheet, dense rates without
sparsity, at the card's full 700 W power limit:
    PEAK_FLOPS_BY_DTYPE = 989e12 FLOP/s bf16 (tensor cores),
                          67e12 FLOP/s fp32 (outside the tensor cores: the
                          port keeps TF32 off, ``device.setup_device``)
    HBM_BW              = 3.35e12 B/s (HBM3)
    LINK_BW             = 450e9 B/s (NVLink 4, one direction of the data
                          sheet's 900 GB/s)
No number here was taken on or for a TPU.  A report is priced at the peak
of the dtype its step computes in (``RooflineReport.dtype``); the
reference's single ``PEAK_FLOPS`` is its bf16 peak.

Terms (seconds per step):
    compute    = global_FLOPs      / (chips * peak_flops[dtype])
    memory     = global_bytes      / (chips * hbm_bw)
    collective = global_coll_bytes / (chips * link_bw)

On one card there are no collective bytes, so the collective term is 0.
The port's dry run counts FLOPs with ``torch.utils.flop_counter`` and
bytes with ``utils.trace_cost`` over one step traced eagerly; no program is
partitioned, so per-device is the whole step.

MODEL_FLOPS (the useful compute): 6*N*D for training (N = active params for
MoE), 2*N*D for forward-only serving; D = tokens processed in the step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import layer_kinds

PEAK_FLOPS_BY_DTYPE = {"bf16": 989e12, "fp32": 67e12}
HBM_BW = 3.35e12
LINK_BW = 450e9


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    per_device_flops: float
    per_device_bytes: float
    per_device_coll_bytes: float
    model_flops_global: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0
    step_s: float = 0.0
    mfu: float = 0.0
    dtype: str = "bf16"

    def finalize(self) -> "RooflineReport":
        peak = PEAK_FLOPS_BY_DTYPE[self.dtype]
        self.compute_s = self.per_device_flops / peak
        self.memory_s = self.per_device_bytes / HBM_BW
        self.collective_s = self.per_device_coll_bytes / LINK_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        counted_global = self.per_device_flops * self.chips
        self.useful_ratio = (self.model_flops_global / counted_global
                             if counted_global else 0.0)
        self.step_s = max(terms.values())
        peak_total = self.chips * peak
        self.mfu = (self.model_flops_global / (self.step_s * peak_total)
                    if self.step_s else 0.0)
        return self

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_ms": round(self.compute_s * 1e3, 3),
            "memory_ms": round(self.memory_s * 1e3, 3),
            "collective_ms": round(self.collective_s * 1e3, 3),
            "bottleneck": self.bottleneck,
            "useful_ratio": round(self.useful_ratio, 3),
            "roofline_step_ms": round(self.step_s * 1e3, 3),
            "mfu_bound": round(self.mfu, 3),
        }


def _mixer_params(cfg, sub) -> int:
    d = cfg.d_model
    if sub.kind == "attn":
        dh = cfg.resolved_head_dim
        return d * (cfg.n_heads * dh) * 2 + d * (cfg.n_kv_heads * dh) * 2
    spec = cfg.ssm
    d_inner = spec.expand * d
    n_heads = d_inner // spec.head_dim
    d_in_proj = 2 * d_inner + 2 * spec.d_state + n_heads
    return d * d_in_proj + d_inner * d


def _encdec_params(cfg) -> int:
    """Encoder layers and the decoder's cross-attention."""
    d = cfg.d_model
    if not cfg.enc_layers:
        return 0
    mult = 3 if cfg.mlp_gated else 2
    return (cfg.enc_layers * (4 * d * d + mult * d * cfg.d_ff)
            + cfg.n_layers * 4 * d * d)


def active_params(cfg) -> float:
    """Active (per-token) parameter count — MoE counts top_k + shared
    experts, not the full expert bank.  Computed from config dims."""
    d = cfg.d_model
    # input-embedding lookups are gathers (0 matmul FLOPs); only the LM head
    # projection contributes compute, tied or not
    total = cfg.vocab * d
    for sub in layer_kinds(cfg):
        total += _mixer_params(cfg, sub)
        if sub.ffn == "mlp":
            ff = sub.d_ff_override or cfg.d_ff
            total += (3 if cfg.mlp_gated else 2) * d * ff
        elif sub.ffn == "moe":
            spec = cfg.moe
            total += 3 * d * spec.d_expert * (spec.top_k + spec.n_shared)
            total += d * spec.n_experts  # router
    return float(total + _encdec_params(cfg))


def total_params(cfg) -> float:
    """Full parameter count (MoE counts every expert)."""
    d = cfg.d_model
    total = cfg.vocab * d
    if not cfg.tie_embeddings:
        total += cfg.vocab * d
    for sub in layer_kinds(cfg):
        total += _mixer_params(cfg, sub)
        if sub.ffn == "mlp":
            ff = sub.d_ff_override or cfg.d_ff
            total += (3 if cfg.mlp_gated else 2) * d * ff
        elif sub.ffn == "moe":
            spec = cfg.moe
            total += 3 * d * spec.d_expert * (spec.n_experts + spec.n_shared)
            total += d * spec.n_experts
    return float(total + _encdec_params(cfg))


def model_flops(cfg, shape, density: float = 1.0) -> float:
    """6*N_active*D for train, 2*N_active*D for serve steps.  ``density``
    scales for DisPFL sparse models (coordinate density)."""
    n = active_params(cfg) * density
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per sequence


def build_report(arch_cfg, shape, mesh_name: str, chips: int,
                 cost: dict, coll_bytes_per_device: float,
                 density: float = 1.0, dtype: str = "bf16") -> RooflineReport:
    flops = float(cost.get("flops", 0.0))
    bts = float(cost.get("bytes accessed", 0.0))
    return RooflineReport(
        arch=arch_cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        per_device_flops=flops, per_device_bytes=bts,
        per_device_coll_bytes=coll_bytes_per_device,
        model_flops_global=model_flops(arch_cfg, shape, density),
        dtype=dtype,
    ).finalize()


def measured_phase_rows(phase_summary: dict,
                        analytic: Optional[dict] = None,
                        dtype: str = "bf16") -> list[dict]:
    """Predicted-vs-observed rows from a ``repro_torch.obs`` run.

    ``phase_summary`` is ``repro_torch.obs.export.phase_summary`` output
    (``{phase: {count, total_s, mean_s, max_s}}`` of *measured* spans);
    ``analytic`` optionally maps a phase name to ``(quantity, unit)`` with
    unit ``"flops"`` or ``"bytes"`` — the analytic cost of ONE call, priced
    on the H100 (the ``dtype`` peak FLOP/s or HBM bandwidth) into a
    predicted ms so the report shows the roofline model next to what the
    host actually spent.  ``achieved_per_s`` is quantity / observed seconds
    — the honest rate, however far from the roof the host is.
    """
    rates = {"flops": PEAK_FLOPS_BY_DTYPE[dtype], "bytes": HBM_BW}
    rows = []
    for phase in sorted(phase_summary):
        agg = phase_summary[phase]
        row = {
            "phase": phase,
            "calls": int(agg["count"]),
            "observed_ms_per_call": round(agg["mean_s"] * 1e3, 4),
            "observed_total_ms": round(agg["total_s"] * 1e3, 3),
        }
        spec = (analytic or {}).get(phase)
        if spec is not None:
            quantity, unit = spec
            if unit not in rates:
                raise ValueError(f"analytic unit must be flops|bytes, "
                                 f"got {unit!r}")
            row["analytic_" + unit] = float(quantity)
            row["predicted_ms_per_call"] = round(
                quantity / rates[unit] * 1e3, 6)
            if agg["mean_s"] > 0:
                row["achieved_per_s"] = float(quantity / agg["mean_s"])
        rows.append(row)
    return rows
