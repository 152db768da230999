"""Device selection and the numeric settings the parity contract needs."""
from __future__ import annotations

import os

import torch

#: cuBLAS's workspace, fixed before the first handle is made: a captured
#: step and the same step run eagerly then get one workspace size on every
#: stream, hence the same GEMM algorithms and bits (32 MiB, Hopper's size)
CUBLAS_WORKSPACE = ":4096:8"


def setup_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``device`` and fix the fp32 settings every entry point needs.

    CUDA is the default.  When it is asked for and no GPU is present this
    raises: there is no silent CPU fallback, the CPU must be asked for.
    TF32 is switched off for matmuls and for cuDNN convolutions
    (``cudnn.allow_tf32`` defaults to True), so convolutions keep fp32
    parity with the reference; bf16 GEMMs reduce in fp32 (cuBLAS may
    otherwise reduce them in bf16; the reference accumulates its bf16
    products in fp32); and cuDNN is held to deterministic
    algorithms (no autotuning, no atomics in the weight gradients), so two
    runs from one state give the same bits on the card — what the
    simulator's sync mode and its resumed runs are checked against.  Sorts
    are made stable at each call site (``torch.argsort(..., stable=True)``).
    ``CUBLAS_WORKSPACE_CONFIG`` is set to ``CUBLAS_WORKSPACE`` unless the
    environment already sets it (``utils.graph``'s captured steps).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {str(device)!r}")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
