"""Build the CUDA sources under ``csrc/`` with nvcc and load them via ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``_build/lib<name>-<hash>.so`` beside this file (the directory is
git-ignored).  All missing libraries are compiled at once, one ``nvcc`` per
source started together, on first use — so the first kernel call of a
process, or ``chip_smoke.py``, builds everything from the checkout.  The
hash covers the source and the flags: a changed source is rebuilt, an
unchanged one reused.  Each build is counted in the process's ``torch``
counter set (``backend_compiles``, ``backend_compile_s``), so a run archive
shows the builds its first kernel call paid for.  ``--use_fast_math`` is
deliberately absent: IEEE division and rounding are part of the kernels'
parity contract.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.obs import install_torch_hooks

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built on the machine with the GPU")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{name: compiler output}`` for the sources compiled by this
    call (ptxas register/spill lines included); raises with the compiler's
    output if any compile fails."""
    todo = [(s, _target(s)) for s in sources() if not _target(s).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, errors = {}, []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[src.stem] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)     # atomic: concurrent builders never see a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    hooks = install_torch_hooks()
    hooks.counter("backend_compiles").inc(len(todo))
    hooks.counter("backend_compile_s").inc(time.perf_counter() - t0)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, building it on first use."""
    if name not in _LIBS:
        build_all()
        _LIBS[name] = ctypes.CDLL(str(_target(CSRC / f"{name}.cu")))
    return _LIBS[name]


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of ``csrc/<lib_name>.cu`` with its argument types
    declared (pointers and the stream as ``c_void_p``, ints as ``c_int``);
    each returns a ``cudaError_t``.  Declared once per process."""
    key = f"{lib_name}.{fn_name}"
    if key not in _FNS:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return _FNS[key]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def launch(fn: ctypes._CFuncPtr, t: torch.Tensor, *args) -> int:
    """Call the C entry ``fn`` with ``args`` followed by the current stream
    of ``t``'s card; returns its ``cudaError_t``.  That card is made the
    current device for the call only when it is not already (the device
    guard costs a few microseconds a call; so does ``torch.cuda.
    current_stream``, hence the raw getter that PyTorch's own generated
    kernels use)."""
    index = t.get_device()
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
