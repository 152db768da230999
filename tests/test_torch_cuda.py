"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``cuda`` and skips, with the reason, where
``torch.cuda.is_available()`` is False.  This file imports torch and the
port only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel must equal its plain version bit for bit (fp32 and bf16 gossip,
fp32 and fp16 payload values, any alpha).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.gossip_avg import gossip_avg, gossip_avg_plain
from repro_torch.kernels.packed_accum import (
    BLOCK_N,
    packed_accum,
    packed_accum_plain,
)
from repro_torch.sparse.packed import pack_bits

pytestmark = [pytest.mark.tier1, pytest.mark.cuda]


def _gossip_inputs(j, n, seed):
    rng = np.random.default_rng(seed)
    m = (rng.random((j, n)) < 0.5).astype(np.float32)
    w = (rng.normal(size=(j, n)) * m).astype(np.float32)
    return w, m


def _fold_inputs(n, density, seed):
    rng = np.random.default_rng(seed)
    flags = rng.random(n) < density
    values = rng.normal(size=int(flags.sum())).astype(np.float32)
    num0 = rng.normal(size=n).astype(np.float32)
    den0 = rng.random(n).astype(np.float32)
    return flags, values, num0, den0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (and nvcc to build the kernels); "
                    "torch.cuda.is_available() is False here")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("j,n", [(1, 128), (4, 1000), (7, 5000),
                                 (4, 2_359_296)])
def test_gossip_kernel_equals_plain_on_card(cuda_device, dtype, j, n):
    w, m = _gossip_inputs(j, n, n + j)
    wt = torch.from_numpy(w).to(cuda_device, dtype)
    mt = torch.from_numpy(m).to(cuda_device, dtype)
    got = gossip_avg(list(wt), list(mt), mt[0])
    torch.cuda.synchronize()
    want = gossip_avg_plain(list(wt), list(mt), mt[0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1000, 3 * BLOCK_N, 2_359_296])
@pytest.mark.parametrize("alpha", [1.0, 0.75])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.float16])
def test_fold_kernel_equals_plain_on_card(cuda_device, n, alpha, vdtype):
    flags, values, num0, den0 = _fold_inputs(n, 0.5, n)
    words = pack_bits(torch.from_numpy(flags).to(cuda_device))
    vals = torch.from_numpy(values).to(cuda_device, vdtype)
    num, den = (torch.from_numpy(x).to(cuda_device) for x in (num0, den0))
    got_num, got_den = packed_accum(num.clone(), den.clone(), words, vals, alpha)
    torch.cuda.synchronize()
    want_num, want_den = packed_accum_plain(num.clone(), den.clone(), words,
                                            vals, alpha)
    assert torch.equal(got_num, want_num)
    assert torch.equal(got_den, want_den)


@pytest.mark.parametrize("extra", [-1, 1])
def test_fold_kernel_refuses_wrong_value_count(cuda_device, extra):
    flags, values, num0, den0 = _fold_inputs(3 * BLOCK_N, 0.5, 7)
    words = pack_bits(torch.from_numpy(flags).to(cuda_device))
    vals = torch.zeros(values.size + extra, device=cuda_device)
    num, den = (torch.from_numpy(x).to(cuda_device) for x in (num0, den0))
    with pytest.raises(ValueError, match="set bits"):
        packed_accum(num, den, words, vals)
