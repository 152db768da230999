"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``cuda`` and skips, with the reason, where
``torch.cuda.is_available()`` is False.  This file imports torch and the
port only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The gossip and fold kernels must equal their plain versions bit for bit
(fp32 and bf16 gossip, fp32 and fp16 payload values, any alpha).  The
masked matmul sums in another order than cuBLAS, so it agrees with its
plain version to atol 1e-5 and rtol 1e-5 on inputs scaled as the served
MLP's (x ~ N(0, 1), w ~ N(0, 1/K)); a user's rows in a mixed batch are
bit-equal to the same user served alone.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.gossip_avg import gossip_avg, gossip_avg_plain
from repro_torch.kernels import masked_matmul as mmk
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


def _mm_inputs(u, m, k, n, density, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((u, m, k)).astype(np.float32)
    w = (rng.standard_normal((u, k, n)) / np.sqrt(k)).astype(np.float32)
    mask = (rng.random((u, k, n)) < density).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, w, mask))


MM_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(64, 128, 128), (128, 256, 128),
                                   (70, 200, 90), (13, 50, 17)])
@pytest.mark.parametrize("density", [0.0, 0.2, 1.0])
def test_masked_matmul_kernel_matches_plain_on_card(cuda_device, shape,
                                                    density):
    m, k, n = shape
    x, w, mask = (t[0] for t in _mm_inputs(1, m, k, n, density, m + k,
                                           cuda_device))
    launches = mmk.LAUNCHES
    got = mmk.masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    assert mmk.LAUNCHES == launches + 1
    torch.testing.assert_close(got, mmk.masked_matmul_plain(x, w, mask),
                               **MM_TOL)


@pytest.mark.parametrize("u,m", [(256, 4), (7, 1), (3, 16), (2, 33)])
@pytest.mark.parametrize("k,n", [(64, 128), (128, 128), (128, 32)])
def test_batched_kernel_matches_plain_at_serve_shapes(cuda_device, u, m, k, n):
    x, w, mask = _mm_inputs(u, m, k, n, 0.5, u * m + k + n, cuda_device)
    got = mmk.batched_masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, mmk.batched_masked_matmul_plain(x, w, mask), **MM_TOL)


def test_batched_kernel_skips_empty_tiles_exactly(cuda_device):
    """Whole empty 128x128 tiles (and so empty kernel tiles): the result
    equals the plain version, and the dead tiles add nothing."""
    x, w, mask = _mm_inputs(3, 5, 256, 384, 0.3, 1, cuda_device)
    mask[:, :128, 128:] = 0.0
    mask[1, 128:, :] = 0.0
    assert mmk.block_occupancy(mask) < 1.0
    got = mmk.batched_masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, mmk.batched_masked_matmul_plain(x, w, mask), **MM_TOL)
    live = mmk.batched_masked_matmul(x[1:2, :, :128].contiguous(),
                                     w[1:2, :128].contiguous(),
                                     mask[1:2, :128].contiguous())
    assert torch.equal(got[1:2], live)


def test_batched_kernel_mixed_batch_equals_alone(cuda_device):
    u, m, k, n = 16, 4, 128, 128
    x, w, mask = _mm_inputs(u, m, k, n, 0.5, 2, cuda_device)
    mixed = mmk.batched_masked_matmul(x, w, mask)
    for i in (0, 5, 15):
        for slot in (i, 0):
            xs, ws, ms = (torch.zeros_like(t) for t in (x, w, mask))
            xs[slot], ws[slot], ms[slot] = x[i], w[i], mask[i]
            alone = mmk.batched_masked_matmul(xs, ws, ms)
            assert torch.equal(alone[slot], mixed[i]), (i, slot)


def test_batched_kernel_refuses_bad_dtype_and_shapes(cuda_device):
    x, w, mask = _mm_inputs(2, 3, 8, 5, 0.5, 3, cuda_device)
    launches = mmk.LAUNCHES
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32"):
            mmk.batched_masked_matmul(x.to(dtype), w.to(dtype), mask)
    with pytest.raises(ValueError, match="chain"):
        mmk.batched_masked_matmul(x, w[:, :7].contiguous(), mask)
    with pytest.raises(ValueError, match="chain"):
        mmk.batched_masked_matmul(x[:1].contiguous(), w, mask)
    with pytest.raises(ValueError, match="on cpu"):
        mmk.batched_masked_matmul(x, w, mask.cpu())
    assert mmk.LAUNCHES == launches
