"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``cuda`` and skips, with the reason, where
``torch.cuda.is_available()`` is False.  This file imports torch and the
port only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The gossip, fold (flat and stacked rows) and prune/regrow kernels must
equal their plain versions bit for bit (fp32 and bf16 gossip, fp32 and fp16
flat and stacked payload values, any alpha, per-row thresholds, ties, zero
gradients, every (weight, mask) dtype pair of the prune/regrow kernel).
The masked matmul sums in another order than cuBLAS, so it agrees with its
plain version to atol 1e-5 and rtol 1e-5 on inputs scaled as the served
MLP's (x ~ N(0, 1), w ~ N(0, 1/K)), and its bf16 entries within one bf16
ulp of the plain output plus that atol (``within_bf16_ulp``: the same
fp32 sums, in another order, each rounded once to bf16); a user's rows in a mixed batch are
bit-equal to the same user served alone; the prune/regrow kernel also at
the LM mask update's full-width leaf and once per sparsifiable leaf of
``launch.steps.make_mask_update_step``.  SubFedAvg's server mix (the
gossip kernel) and dpsgd's async ``mix_one`` (the fold kernel at Metropolis
weights) equal the same calls on the CPU bit for bit.  An ``ordered``
stacked round on
the card agrees with the same round on the CPU up to the convolutions' fp32
rounding: masks on all but a 1e-3 share of coordinates, parameters within
1e-3 where the masks agree.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.gossip_avg import gossip_avg, gossip_avg_plain
from repro_torch.kernels import masked_matmul as mmk
from repro_torch.kernels import packed_accum as pa
from repro_torch.kernels import prune_regrow as pr
from repro_torch.kernels.packed_accum import (
    BLOCK_N,
    packed_accum,
    packed_accum_plain,
)
from repro_torch.sparse.packed import pack_bits, pack_bits_rows

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
    launches = pa.LAUNCHES
    with pytest.raises(ValueError, match="set bits"):
        packed_accum(num, den, words, vals)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == launches
    assert torch.equal(num.cpu(), torch.from_numpy(num0))
    assert torch.equal(den.cpu(), torch.from_numpy(den0))


@pytest.mark.parametrize("n,density", [(2 ** 23 + 17, 0.5), (5, 0.5),
                                       (31, 0.9), (3 * BLOCK_N + 5, 0.0),
                                       (130, 1.0)])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.float16])
def test_fold_kernel_scan_edges_on_card(cuda_device, n, density, vdtype):
    """A long leaf (2^23 + 17 coordinates: the scan looks back over 257
    blocks, several 32-block windows, and the fold has 8193 blocks), leaves
    under one word, an empty payload and a full one, and the unaligned
    tail: bit-equal to the plain version, one launch each."""
    flags, values, num0, den0 = _fold_inputs(n, density, n + 1)
    words = pack_bits(torch.from_numpy(flags).to(cuda_device))
    vals = torch.from_numpy(values).to(cuda_device, vdtype)
    num, den = (torch.from_numpy(x).to(cuda_device) for x in (num0, den0))
    launches = pa.LAUNCHES
    got = packed_accum(num.clone(), den.clone(), words, vals, 0.75)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == launches + 1
    want = packed_accum_plain(num.clone(), den.clone(), words, vals, 0.75)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_fold_kernel_unaligned_views_on_card(cuda_device):
    """Accumulators that start off a 16-byte boundary take the scalar path
    and still equal the plain version."""
    n = 5000
    flags, values, num0, den0 = _fold_inputs(n + 1, 0.5, 3)
    flags = flags[:n]
    words = pack_bits(torch.from_numpy(flags).to(cuda_device))
    vals = torch.from_numpy(values[: int(flags.sum())]).to(cuda_device)
    num, den = (torch.from_numpy(x).to(cuda_device) for x in (num0, den0))
    got = packed_accum(num.clone()[1:], den.clone()[1:], words, vals)
    torch.cuda.synchronize()
    want = packed_accum_plain(num.clone()[1:], den.clone()[1:], words, vals)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


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


@pytest.mark.parametrize("shape", [(4, 512, 128), (7, 1000, 96),
                                   (128, 300, 64), (13, 256, 90),
                                   (3, 129, 17), (16, 70, 130)])
@pytest.mark.parametrize("density", [0.2, 1.0])
def test_batched_kernel_staging_shapes_on_card(cuda_device, shape, density):
    """K over several staged chunks (512, 1000), M=128 rows, and N that is
    not a multiple of 4 (90, 17, 130: the 4-byte copies), against the plain
    version, one launch each."""
    m, k, n = shape
    x, w, mask = _mm_inputs(3, m, k, n, density, m + k + n, cuda_device)
    launches = mmk.LAUNCHES
    got = mmk.batched_masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    assert mmk.LAUNCHES == launches + 1
    torch.testing.assert_close(
        got, mmk.batched_masked_matmul_plain(x, w, mask), **MM_TOL)


@pytest.mark.parametrize("k,n", [(256, 256), (1000, 130)])
def test_batched_kernel_checkerboard_of_empty_tiles(cuda_device, k, n):
    """Every other (32, 32) tile of each user's mask empty, in a
    checkerboard (other users' phases differ): equal to the plain version,
    and a user's rows do not change when its dead tiles' weights do."""
    x, w, mask = _mm_inputs(4, 9, k, n, 0.5, k + n, cuda_device)
    kt = torch.arange(k, device=cuda_device)[:, None] // 32
    nt = torch.arange(n, device=cuda_device)[None, :] // 32
    for u in range(4):
        mask[u] *= ((kt + nt + u) % 2 == 0).float()
    assert mmk.block_occupancy(mask, 32, 32) < 0.6
    got = mmk.batched_masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, mmk.batched_masked_matmul_plain(x, w, mask), **MM_TOL)
    w2 = torch.where(mask == 0, torch.full_like(w, 1e30), w)
    assert torch.equal(mmk.batched_masked_matmul(x, w2, mask), got)


@pytest.mark.parametrize("u,m,k,n", [(256, 4, 128, 128), (9, 3, 1000, 130),
                                     (5, 20, 300, 64)])
def test_batched_kernel_mixed_equals_alone_at_staging_shapes(cuda_device, u,
                                                             m, k, n):
    x, w, mask = _mm_inputs(u, m, k, n, 0.5, u + k, cuda_device)
    mixed = mmk.batched_masked_matmul(x, w, mask)
    for i in (0, u // 2, u - 1):
        xs, ws, ms = (torch.zeros_like(t) for t in (x, w, mask))
        xs[i], ws[i], ms[i] = x[i], w[i], mask[i]
        alone = mmk.batched_masked_matmul(xs, ws, ms)
        assert torch.equal(alone[i], mixed[i]), i
        solo = mmk.batched_masked_matmul(x[i:i + 1].contiguous(),
                                         w[i:i + 1].contiguous(),
                                         mask[i:i + 1].contiguous())
        assert torch.equal(solo[0], mixed[i]), i


def test_batched_kernel_refuses_bad_dtype_and_shapes(cuda_device):
    """Operand types the kernel has no entry for are refused with the
    supported pairs named (bf16 x and w with an fp32 mask has one since
    the bf16 entries: ``test_bf16_masked_matmul_*``)."""
    x, w, mask = _mm_inputs(2, 3, 8, 5, 0.5, 3, cuda_device)
    launches = mmk.LAUNCHES
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32"):
            mmk.batched_masked_matmul(x.to(dtype), w.to(dtype), mask)
    with pytest.raises(TypeError, match="bfloat16"):
        mmk.batched_masked_matmul(x.to(torch.bfloat16), w, mask)
    with pytest.raises(ValueError, match="chain"):
        mmk.batched_masked_matmul(x, w[:, :7].contiguous(), mask)
    with pytest.raises(ValueError, match="chain"):
        mmk.batched_masked_matmul(x[:1].contiguous(), w, mask)
    with pytest.raises(ValueError, match="on cpu"):
        mmk.batched_masked_matmul(x, w, mask.cpu())
    assert mmk.LAUNCHES == launches


def _rows_inputs(k, n, seed, device):
    """K payloads of ragged density (row 1 empty) with left-aligned,
    zero-padded values, and non-zero accumulators."""
    rng = np.random.default_rng(seed)
    dens = np.linspace(0.9, 0.1, k)
    dens[1 % k] = 0.0
    flags = rng.random((k, n)) < dens[:, None]
    nnz = flags.sum(axis=1)
    values = np.zeros((k, max(int(nnz.max()), 1)), np.float32)
    for r in range(k):
        values[r, : nnz[r]] = rng.normal(size=nnz[r])
    num0 = rng.normal(size=(k, n)).astype(np.float32)
    den0 = rng.random((k, n)).astype(np.float32)
    words = pack_bits_rows(torch.from_numpy(flags).to(device))
    return (torch.from_numpy(num0).to(device), torch.from_numpy(den0).to(device),
            words, torch.from_numpy(values).to(device),
            torch.from_numpy(nnz.astype(np.int32)).to(device))


@pytest.mark.parametrize("k,n", [(4, 1000), (3, 3 * BLOCK_N + 5),
                                 (4, 2_359_296)])
@pytest.mark.parametrize("alpha", [1.0, 0.75])
def test_fold_rows_kernel_equals_plain_on_card(cuda_device, k, n, alpha):
    num, den, words, values, nnz = _rows_inputs(k, n, n + k, cuda_device)
    launches = pa.LAUNCHES_ROWS
    got = pa.packed_accum_rows(num.clone(), den.clone(), words, values, nnz,
                               alpha)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_ROWS == launches + 1
    want = pa.packed_accum_rows_plain(num.clone(), den.clone(), words, values,
                                      nnz, alpha)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [1000 + 3, 3 * BLOCK_N + 5, 17])
def test_fold_rows_kernel_ragged_rows_on_card(cuda_device, n):
    """K=8 rows of ragged density (one empty) whose length is not a
    multiple of 4 (so no row is 16-byte aligned): bit-equal to the plain
    version, one launch."""
    num, den, words, values, nnz = _rows_inputs(8, n, n + 8, cuda_device)
    launches = pa.LAUNCHES_ROWS
    got = pa.packed_accum_rows(num.clone(), den.clone(), words, values, nnz,
                               0.75)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_ROWS == launches + 1
    want = pa.packed_accum_rows_plain(num.clone(), den.clone(), words, values,
                                      nnz, 0.75)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_fold_rows_kernel_scan_beyond_resident_blocks(cuda_device):
    """K=8 rows of 2^23 + 17 coordinates: 2056 scan blocks, more than the
    card holds at once (8 of 256 threads on each of 132 SMs), so blocks
    must take their tickets in order for the look-back to finish."""
    n = 2 ** 23 + 17
    num, den, words, values, nnz = _rows_inputs(8, n, 5, cuda_device)
    got = pa.packed_accum_rows(num.clone(), den.clone(), words, values, nnz,
                               0.75)
    torch.cuda.synchronize()
    want = pa.packed_accum_rows_plain(num.clone(), den.clone(), words, values,
                                      nnz, 0.75)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("extra", [-1, 1])
def test_fold_rows_kernel_refuses_wrong_nnz(cuda_device, extra):
    num, den, words, values, nnz = _rows_inputs(4, 3 * BLOCK_N, 7,
                                                cuda_device)
    bad = nnz.clone()
    bad[2] += extra
    num0, den0 = num.clone(), den.clone()
    launches = pa.LAUNCHES_ROWS
    with pytest.raises(ValueError, match="set bits"):
        pa.packed_accum_rows(num, den, words, values, bad)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_ROWS == launches
    assert torch.equal(num, num0) and torch.equal(den, den0)


def _pr_inputs(k, n, seed, device, ties=False):
    rng = np.random.default_rng(seed)
    m = (rng.random((k, n)) < 0.5).astype(np.float32)
    w = (rng.normal(size=(k, n)) * m).astype(np.float32)
    g = rng.normal(size=(k, n)).astype(np.float32)
    if ties:                      # every |w| and |g| equal, signs mixed
        w = np.sign(w) * m * 0.5
        g = np.where(rng.random((k, n)) < 0.5, -0.25, 0.25)
    g[k - 1] = 0.0                # one row of zero gradients
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device) for a in (w, g, m))


@pytest.mark.parametrize("k,n", [(1, 1000), (4, 4097), (4, 2_359_296)])
@pytest.mark.parametrize("ties", [False, True])
def test_prune_regrow_kernel_equals_plain_on_card(cuda_device, k, n, ties):
    w, g, m = _pr_inputs(k, n, n + k, cuda_device, ties)
    th = torch.stack([torch.linspace(0.0, 1.5, k), torch.linspace(1.0, 0.0, k)],
                     dim=1).to(cuda_device).contiguous()
    th_sorted = pr.sort_thresholds(w, g, m, n // 4, n // 8)
    for t in (th, th_sorted):
        launches = pr.LAUNCHES
        got = pr.prune_regrow_rows(w, g, m, t)
        torch.cuda.synchronize()
        assert pr.LAUNCHES == launches + 1
        want = pr.prune_regrow_rows_plain(w, g, m, t)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
        assert float(got[0][k - 1][m[k - 1] == 0].sum()) == 0.0


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_prune_regrow_layer_on_card_equals_cpu(cuda_device, rate):
    """The one-layer entry point: sort-picked thresholds on the card, then
    the kernel, equal to the same call on the CPU (plain version)."""
    w, g, m = _pr_inputs(1, 9 * 64 * 64, 11, "cpu")
    want = pr.prune_regrow(w.reshape(9, 64, 64), g.reshape(9, 64, 64),
                           m.reshape(9, 64, 64), rate)
    got = pr.prune_regrow(*(t.reshape(9, 64, 64).to(cuda_device)
                            for t in (w, g, m)), rate)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_prune_regrow_full_width_leaf_equals_plain_on_card(cuda_device):
    """The largest leaf the LM mask update hands the kernel: gemma3-1b's
    tied embedding table for K=2 clients (2 x 262,144 x 1152 coordinates),
    held density 0.5, prune rate 0.25, thresholds by ``sort_thresholds``."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS["gemma3-1b"]
    k, n = 2, cfg.vocab * cfg.d_model
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    m = (torch.rand((k, n), generator=gen, device=cuda_device) < 0.5).float()
    w = torch.randn((k, n), generator=gen, device=cuda_device) * m
    g = torch.randn((k, n), generator=gen, device=cuda_device)
    n_active = round(0.5 * n)
    n_prune = int(np.ceil(np.float32(0.25) * np.float32(n_active)))
    th = pr.sort_thresholds(w, g, m, n_active - n_prune, n_prune)
    launches = pr.LAUNCHES
    got = pr.prune_regrow_rows(w, g, m, th)
    torch.cuda.synchronize()
    assert pr.LAUNCHES == launches + 1
    want = pr.prune_regrow_rows_plain(w, g, m, th)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def test_lm_mask_update_step_launches_per_sparsifiable_leaf(cuda_device):
    """``make_mask_update_step`` on the card: one prune/regrow launch per
    sparsifiable leaf, int8 masks within the reference test's budget
    bounds, every weight zero outside its new mask."""
    from repro_torch.configs import INPUT_SHAPES, SMOKE_ARCHS
    from repro_torch.core.masks import apply_mask, init_mask
    from repro_torch.launch import steps
    from repro_torch.models import bind
    from repro_torch.scale.stacked import default_threshold_sparsifiable
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_stack

    cfg = SMOKE_ARCHS["qwen3-moe-30b-a3b"]
    api = bind(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ps = [api.init(gen) for _ in range(2)]
    ms = [tree_map(lambda t: t.to(torch.int8), init_mask(gen, p, 0.5))
          for p in ps]
    params = tree_stack([apply_mask(p, m) for p, m in zip(ps, ms)])
    masks = tree_stack(ms)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 2, 16), generator=gen,
                                     device=cuda_device),
             "labels": torch.randint(0, cfg.vocab, (2, 2, 16), generator=gen,
                                     device=cuda_device)}
    plan = steps.ScalePlan(cfg, INPUT_SHAPES["train_4k"], 2, 2)
    launches = pr.LAUNCHES
    new_params, new_masks = steps.make_mask_update_step(api, plan)(
        params, masks, batch, 0.3)
    torch.cuda.synchronize()
    sparse = [x for x in tree_leaves(params)
              if default_threshold_sparsifiable(x)]
    assert sparse and pr.LAUNCHES - launches == len(sparse)
    for w, m, m0 in zip(tree_leaves(new_params), tree_leaves(new_masks),
                        tree_leaves(masks)):
        assert m.dtype == torch.int8
        assert bool(torch.all(w[m == 0] == 0))
        if default_threshold_sparsifiable(m0):
            n = m0[0].numel()
            after = m.reshape(2, -1).sum(1).cpu().numpy()
            assert np.all(after <= 0.5 * n + max(8, 0.02 * n))
            assert np.all(after >= 0.5 * n * 0.7 - max(8, 0.02 * n))


def test_ordered_scale_round_on_card_matches_cpu(cuda_device):
    from repro_torch.data.loader import build_federated_image_task
    from repro_torch.fl.base import FLConfig, make_cnn_task
    from repro_torch.fl.engine import make_strategy
    from repro_torch.kernels import gossip_avg as ga
    from repro_torch.scale import ScaleEngine
    from repro_torch.utils.tree import tree_leaves, tree_map

    clients, _ = build_federated_image_task(
        0, n_clients=4, partition="pathological", n_train_per_class=12,
        n_test_per_client=8, hw=8)
    cfg = FLConfig(n_clients=4, rounds=1, local_epochs=1, batch_size=8,
                   degree=2)
    engines = [ScaleEngine(make_strategy("dispfl"),
                           make_cnn_task("smallcnn", 10, 8, width=4,
                                         device=dev), clients, cfg,
                           reduction="ordered")
               for dev in (cuda_device, "cpu")]
    gpu, cpu = engines
    cpu.state = tree_map(lambda x: x.detach().cpu().clone(), gpu.state)
    launches = ga.LAUNCHES
    gpu.run(), cpu.run()
    assert ga.LAUNCHES > launches
    n = mismatched = 0
    for a, b in zip(tree_leaves(gpu.state["masks"]),
                    tree_leaves(cpu.state["masks"])):
        n += a.numel()
        mismatched += int((a.cpu() != b).sum())
    assert mismatched / n <= 1e-3
    for a, b in zip(tree_leaves(gpu.state["params"]),
                    tree_leaves(cpu.state["params"])):
        same = (a.cpu() != 0) == (b != 0)
        torch.testing.assert_close(a.cpu()[same], b[same], rtol=0, atol=1e-3)


def _trained_pair(name, cuda_device):
    """A K=4 smallcnn loop engine on the CPU after one round (trained
    params; subfedavg's masks pruned) and one on the card holding a copy
    of its state."""
    from repro_torch.data.loader import build_federated_image_task
    from repro_torch.fl.base import FLConfig, make_cnn_task
    from repro_torch.fl.engine import RoundEngine, make_strategy
    from repro_torch.utils.tree import tree_map

    clients, _ = build_federated_image_task(
        0, n_clients=4, partition="pathological", n_train_per_class=24,
        n_test_per_client=16, hw=8)
    cfg = FLConfig(n_clients=4, rounds=2, local_epochs=1, batch_size=16,
                   degree=3)
    cpu, gpu = (RoundEngine(make_strategy(name),
                            make_cnn_task("smallcnn", 10, 8, width=4,
                                          device=dev), clients, cfg,
                            local_exec="loop")
                for dev in ("cpu", cuda_device))
    cpu._run_one_round(0)
    gpu.state = tree_map(lambda x: x.to(cuda_device, copy=True), cpu.state)
    return cpu, gpu


def _assert_tree_bits(gpu_tree, cpu_tree):
    from repro_torch.utils.tree import tree_leaves
    for a, b in zip(tree_leaves(gpu_tree), tree_leaves(cpu_tree), strict=True):
        assert torch.equal(a.cpu(), b)


def test_subfedavg_mix_on_card_equals_cpu(cuda_device):
    """SubFedAvg's server mix: one gossip launch per leaf and selected
    client, bit-equal to the plain version's mix on the CPU."""
    from repro_torch.kernels import gossip_avg as ga
    from repro_torch.utils.tree import tree_leaves

    cpu, gpu = _trained_pair("subfedavg", cuda_device)
    assert any(bool((m == 0).any()) for m in tree_leaves(cpu.state["masks"]))
    ga.LAUNCHES = 0
    gpu.strategy.mix(gpu.state, gpu._make_ctx(1))
    torch.cuda.synchronize()
    launches = ga.LAUNCHES
    cpu.strategy.mix(cpu.state, cpu._make_ctx(1))
    assert gpu.state["_sel"] == cpu.state["_sel"]
    n_leaves = len(tree_leaves(cpu.state["params"][0]))
    assert launches == len(cpu.state["_sel"]) * n_leaves
    _assert_tree_bits(gpu.state["params"], cpu.state["params"])


def test_dpsgd_mix_one_on_card_equals_cpu(cuda_device):
    """dpsgd's async mix: each arrived dense payload folded at its
    Metropolis weight by the fold kernel, bit-equal to the CPU."""
    from repro_torch.kernels import packed_accum as pa
    from repro_torch.utils.tree import tree_leaves

    cpu, gpu = _trained_pair("dpsgd", cuda_device)
    ctx_c, ctx_g = cpu._make_ctx(1), gpu._make_ctx(1)
    senders = [{j: e.strategy.snapshot_message(e.state, j) for j in (0, 2, 3)}
               for e in (cpu, gpu)]
    pa.LAUNCHES = 0
    gpu.strategy.mix_one(gpu.state, 1, senders[1], ctx_g)
    torch.cuda.synchronize()
    launches = pa.LAUNCHES
    cpu.strategy.mix_one(cpu.state, 1, senders[0], ctx_c)
    assert launches == 3 * len(tree_leaves(cpu.state["params"][1]))
    _assert_tree_bits(gpu.state["params"], cpu.state["params"])


def _sim_world(device, **kw):
    """A K=4 smallcnn simulator on ``device`` (the CPU copy of the tests'
    world: pathological data, 3 rounds of 1 epoch)."""
    from repro_torch.data.loader import build_federated_image_task
    from repro_torch.fl.base import FLConfig, make_cnn_task
    from repro_torch.fl.engine import make_strategy
    from repro_torch.sim import SimEngine

    clients, _ = build_federated_image_task(
        0, n_clients=4, partition="pathological", n_train_per_class=24,
        n_test_per_client=16, hw=8)
    cfg = FLConfig(n_clients=4, rounds=3, local_epochs=1, batch_size=16,
                   degree=2)
    return SimEngine(make_strategy("dispfl"),
                     make_cnn_task("smallcnn", 10, 8, width=4, device=device),
                     clients, cfg, **kw)


def test_async_fold_over_device_payloads(cuda_device):
    """The async path on the card: every arrived payload leaf is folded by
    the fold kernel (launches == folds counted by ``sparse.ops``), and one
    activation's ``mix_one`` over device payloads equals the same call on
    CPU copies bit for bit."""
    from repro_torch.sim import LossModel, hetero_speeds
    from repro_torch.sparse import ops as sparse_ops
    from repro_torch.utils.tree import tree_leaves, tree_map

    eng = _sim_world(cuda_device, mode="async", staleness=2, round_s=1.0,
                     uplink="fifo", compute_speeds=hetero_speeds(4, seed=2),
                     loss=LossModel(0.25, timeout_s=0.3))
    sparse_ops.reset_counters()
    pa.LAUNCHES = 0
    res = eng.run()
    assert pa.LAUNCHES == sparse_ops.COUNTERS["accum_calls"] > 0
    assert eng.mixed_messages > 0 and len(res.acc_history) == 3
    assert eng.observed_spread <= 2 and eng.observed_mix_lag <= 2
    strat, state = eng.strategy, eng.state
    senders = {j: strat.snapshot_message(state, j) for j in (0, 2)}
    cpu = lambda t: tree_map(lambda x: x.detach().cpu(), t)  # noqa: E731
    cpu_senders = {j: {"packed": tree_map(
        lambda p: type(p)(p.bitmap.cpu(), p.values.cpu(), p.shape),
        m["packed"], is_leaf=lambda p: hasattr(p, "bitmap"))}
        for j, m in senders.items()}
    on_card = {k: list(v) for k, v in state.items()}
    on_cpu = {k: [cpu(x) for x in v] for k, v in state.items()}
    launches = pa.LAUNCHES
    strat.mix_one(on_card, 1, senders, None)
    torch.cuda.synchronize()
    assert pa.LAUNCHES - launches == 2 * len(tree_leaves(state["params"][1]))
    strat.mix_one(on_cpu, 1, cpu_senders, None)
    for a, b in zip(tree_leaves(on_card["params"][1]),
                    tree_leaves(on_cpu["params"][1])):
        assert torch.equal(a.cpu(), b)


def test_packed_archive_of_device_payloads(cuda_device, tmp_path):
    """Encoding copies device payloads to numpy; decoding onto the card
    gives back the bitmap and values bit for bit, through the archive."""
    from repro_torch.checkpoint.npz import load_pytree, save_pytree
    from repro_torch.checkpoint.packed import decode_packed, encode_packed
    from repro_torch.sparse.packed import pack_tree
    from repro_torch.utils.tree import tree_leaves

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    shapes = {"a": (3, 3, 16, 32), "b": (1000,), "c": (17, 10)}
    w = {k: torch.randn(s, generator=gen, device=cuda_device)
         for k, s in shapes.items()}
    m = {k: (torch.rand(s, generator=gen, device=cuda_device) < 0.4).float()
         for k, s in shapes.items()}
    for dtype in (None, torch.float16):
        msg = {"packed": pack_tree(w, m, dtype=dtype)}
        path = str(tmp_path / "payload.npz")
        save_pytree(path, encode_packed(msg))
        back = decode_packed(load_pytree(path), cuda_device)
        is_p = lambda p: hasattr(p, "bitmap")  # noqa: E731
        for a, b in zip(tree_leaves(msg, is_leaf=is_p),
                        tree_leaves(back, is_leaf=is_p)):
            assert b.bitmap.device.type == b.values.device.type == "cuda"
            assert torch.equal(a.bitmap, b.bitmap) and a.shape == b.shape
            assert a.values.dtype == b.values.dtype
            assert torch.equal(a.values, b.values)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_sim_resume_on_card_bit_identical(cuda_device, mode, tmp_path):
    """Runs on the card from one state give the same bits (cuDNN is held
    deterministic), so a run resumed mid-way equals the uninterrupted one,
    transfers included, and a sync run equals ``RoundEngine``."""
    from repro_torch.fl.engine import RoundEngine, make_strategy
    from repro_torch.sim import hetero_speeds
    from repro_torch.utils.tree import tree_leaves

    kw = (dict(mode="async", staleness=1, round_s=1.0,
               compute_speeds=hetero_speeds(4, seed=2)) if mode == "async"
          else dict(mode="sync", local_exec="loop"))
    full = _sim_world(cuda_device, **kw)       # every engine: the seed's init
    full.run()
    first = _sim_world(cuda_device, **kw)
    mid = str(tmp_path / "mid.npz")
    for m in first.rounds():
        if m.round == 1:
            first.save(mid)
            break
    resumed = _sim_world(cuda_device, **kw).restore(mid)
    resumed.run()
    assert resumed.stats.transfers == full.stats.transfers
    assert resumed.clock.now == full.clock.now
    assert resumed._acc_history == full._acc_history
    for a, b in zip(tree_leaves(resumed.state), tree_leaves(full.state)):
        assert torch.equal(a, b)
    if mode == "sync":
        eng = RoundEngine(make_strategy("dispfl"), full.task, full.clients,
                          full.cfg, local_exec="loop")
        eng.run()
        assert eng._acc_history == full._acc_history
        for a, b in zip(tree_leaves(eng.state), tree_leaves(full.state)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# reduced precision: the bf16 and fp16 entries
# ---------------------------------------------------------------------------

def _bf16_mm(x, w, mask, mask_dtype):
    return (x.to(torch.bfloat16), w.to(torch.bfloat16), mask.to(mask_dtype))


def _entry_launches(counts, before):
    """The C entries whose count moved since ``before`` (a copy of a
    ``LAUNCHES_BY_ENTRY`` table), and by how much."""
    return {e: n - before[e] for e, n in counts.items() if n != before[e]}


_MASK_DTYPES = [torch.float32, torch.bfloat16]
_BF16_ENTRY = {torch.float32: "batched_masked_matmul_bf16",
               torch.bfloat16: "batched_masked_matmul_bf16_mbf16"}


@pytest.mark.parametrize("mask_dtype", _MASK_DTYPES)
@pytest.mark.parametrize("shape", [(64, 128, 128), (128, 256, 128),
                                   (70, 200, 90), (13, 50, 17)])
@pytest.mark.parametrize("density", [0.0, 0.2, 1.0])
def test_bf16_masked_matmul_matches_plain_on_card(cuda_device, shape,
                                                  density, mask_dtype):
    """The reference's kernel sweep at bf16: within one bf16 ulp of the
    plain version, output bf16, one launch counted for the mask dtype's
    entry in both tables; the batched wrapper on the same operands counts
    its launch in ``LAUNCHES_BY_ENTRY`` only."""
    m, k, n = shape
    x, w, mask = _bf16_mm(*(t[0] for t in _mm_inputs(
        1, m, k, n, density, m + k, cuda_device)), mask_dtype)
    launches, launches_u1 = mmk.LAUNCHES, mmk.LAUNCHES_U1
    by_entry = dict(mmk.LAUNCHES_BY_ENTRY)
    u1 = dict(mmk.LAUNCHES_U1_BY_ENTRY)
    got = mmk.masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    assert (mmk.LAUNCHES, mmk.LAUNCHES_U1) == (launches + 1, launches_u1 + 1)
    entry = _BF16_ENTRY[mask_dtype]
    assert _entry_launches(mmk.LAUNCHES_BY_ENTRY, by_entry) == {entry: 1}
    assert _entry_launches(mmk.LAUNCHES_U1_BY_ENTRY, u1) == {entry: 1}
    assert got.dtype == torch.bfloat16
    assert mmk.within_bf16_ulp(got, mmk.masked_matmul_plain(x, w, mask))
    batched = mmk.batched_masked_matmul(x[None], w[None], mask[None])
    torch.cuda.synchronize()
    assert (mmk.LAUNCHES, mmk.LAUNCHES_U1) == (launches + 2, launches_u1 + 1)
    assert _entry_launches(mmk.LAUNCHES_BY_ENTRY, by_entry) == {entry: 2}
    assert _entry_launches(mmk.LAUNCHES_U1_BY_ENTRY, u1) == {entry: 1}
    assert torch.equal(batched[0], got)


# the tensor-core kernel's edges: rows that fill part of an n8 tile (1, 4),
# exactly one (8), spill into a second (9, 16) or span several row tiles
# (128); K a whole k16 step, one past it, and several k tiles (16, 17,
# 200); N one mma half (8), ragged (90: the element copies), whole strips
_BF16_EDGES = [(3, m, k, n) for m in (1, 4, 8, 9, 16, 128)
               for k in (16, 17, 200) for n in (8, 90, 128)]


@pytest.mark.parametrize("mask_dtype", _MASK_DTYPES)
@pytest.mark.parametrize("u,m,k,n", [(256, 4, 128, 128), (7, 1, 64, 128),
                                     (3, 16, 1000, 130), (2, 33, 128, 32)]
                         + _BF16_EDGES)
def test_bf16_batched_kernel_at_serve_and_ragged_shapes(cuda_device, u, m, k,
                                                        n, mask_dtype):
    """Within one bf16 ulp of plain, one launch of the mask dtype's entry,
    and the same bits on a second launch."""
    x, w, mask = _bf16_mm(*_mm_inputs(u, m, k, n, 0.5, u + m + k,
                                      cuda_device), mask_dtype)
    launches = mmk.LAUNCHES
    by_entry = dict(mmk.LAUNCHES_BY_ENTRY)
    got = mmk.batched_masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    assert mmk.LAUNCHES == launches + 1
    assert _entry_launches(mmk.LAUNCHES_BY_ENTRY, by_entry) == {
        _BF16_ENTRY[mask_dtype]: 1}
    assert got.dtype == torch.bfloat16 and got.shape == (u, m, n)
    assert mmk.within_bf16_ulp(got,
                               mmk.batched_masked_matmul_plain(x, w, mask))
    assert torch.equal(mmk.batched_masked_matmul(x, w, mask), got)


@pytest.mark.parametrize("mask_dtype", _MASK_DTYPES)
@pytest.mark.parametrize("u,m,k,n", [(4, 9, 256, 256), (16, 4, 128, 128),
                                     (5, 8, 300, 64), (6, 9, 200, 90),
                                     (3, 20, 128, 32)])
def test_bf16_batched_kernel_skips_dead_tiles_and_mixes_exactly(
        cuda_device, u, m, k, n, mask_dtype):
    """A checkerboard of empty (32, 32) tiles: dead tiles' weights do not
    reach the result, and a user's rows in a mixed batch equal the same
    user alone (every other slot zero) and launched on its own (U=1), at M
    up to one n8 tile and past it."""
    x, w, mask = _bf16_mm(*_mm_inputs(u, m, k, n, 0.5, 8, cuda_device),
                          mask_dtype)
    kt = torch.arange(k, device=cuda_device)[:, None] // 32
    nt = torch.arange(n, device=cuda_device)[None, :] // 32
    for i in range(u):
        mask[i] *= ((kt + nt + i) % 2 == 0).to(mask_dtype)
    got = mmk.batched_masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    assert mmk.within_bf16_ulp(got,
                               mmk.batched_masked_matmul_plain(x, w, mask))
    w2 = torch.where(mask == 0, torch.full_like(w, 1e30), w)
    assert torch.equal(mmk.batched_masked_matmul(x, w2, mask), got)
    for i in (0, u // 2, u - 1):
        xs, ws, ms = (torch.zeros_like(t) for t in (x, w, mask))
        xs[i], ws[i], ms[i] = x[i], w[i], mask[i]
        assert torch.equal(mmk.batched_masked_matmul(xs, ws, ms)[i],
                           got[i]), i
        solo = mmk.batched_masked_matmul(x[i:i + 1].contiguous(),
                                         w[i:i + 1].contiguous(),
                                         mask[i:i + 1].contiguous())
        assert torch.equal(solo[0], got[i]), i


@pytest.mark.parametrize("mask_dtype", _MASK_DTYPES)
@pytest.mark.parametrize("operand", ["x", "w", "m"])
def test_bf16_kernel_unaligned_bases_on_card(cuda_device, mask_dtype,
                                             operand):
    """A contiguous operand whose base lies one element past a 16-byte
    boundary (a slice at an odd element offset) takes the element copies:
    the same bits as the aligned operands' 16-byte copies."""
    ops = dict(zip("xwm", _bf16_mm(*_mm_inputs(4, 5, 128, 64, 0.5, 21,
                                               cuda_device), mask_dtype)))
    want = mmk.batched_masked_matmul(ops["x"], ops["w"], ops["m"])
    t = ops[operand]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
    shifted = buf[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    ops[operand] = shifted
    got = mmk.batched_masked_matmul(ops["x"], ops["w"], ops["m"])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert mmk.within_bf16_ulp(
        got, mmk.batched_masked_matmul_plain(ops["x"], ops["w"], ops["m"]))


@pytest.mark.parametrize("mask_dtype", _MASK_DTYPES)
@pytest.mark.parametrize("u,m,k,n", [(4, 4, 128, 128), (1, 128, 256, 128),
                                     (2, 9, 17, 90)])
def test_bf16_kernel_all_zero_mask_gives_positive_zero(cuda_device,
                                                       mask_dtype, u, m, k,
                                                       n):
    """Every mask tile empty: nothing is multiplied and each output is
    exactly +0.0, whatever the weights hold."""
    x, w, _ = _bf16_mm(*_mm_inputs(u, m, k, n, 0.5, 5, cuda_device),
                       mask_dtype)
    mask = torch.zeros((u, k, n), dtype=mask_dtype, device=cuda_device)
    got = mmk.batched_masked_matmul(x, w, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))
    assert not torch.signbit(got).any()


def _pr_pair_inputs(k, n, seed, device, wdt, mdt, ties=False):
    w, g, m = _pr_inputs(k, n, seed, device, ties)
    return w.to(wdt), g.to(wdt), m.to(mdt)


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16,
                   1: torch.int8}[t.element_size()])


@pytest.mark.parametrize("pair", pr.PAIRS, ids=lambda p: "-".join(
    str(d).replace("torch.", "") for d in p))
@pytest.mark.parametrize("k,n", [(1, 1000), (4, 4097), (2, 1_048_576)])
@pytest.mark.parametrize("ties", [False, True])
def test_prune_regrow_kernel_dtype_pairs_on_card(cuda_device, pair, k, n,
                                                 ties):
    """Every instantiated (weight, mask) pair, bit-equal to the plain
    version, outputs in m's and w's dtypes; thresholds sorted in the
    native dtype equal those of the fp32 widenings."""
    w, g, m = _pr_pair_inputs(k, n, n + k, cuda_device, *pair, ties)
    th = pr.sort_thresholds(w, g, m, n // 4, n // 8)
    assert torch.equal(th, pr.sort_thresholds(w.float(), g.float(),
                                              m.float(), n // 4, n // 8))
    launches, by_entry = pr.LAUNCHES, dict(pr.LAUNCHES_BY_ENTRY)
    got = pr.prune_regrow_rows(w, g, m, th)
    torch.cuda.synchronize()
    assert pr.LAUNCHES == launches + 1
    assert _entry_launches(pr.LAUNCHES_BY_ENTRY, by_entry) == {
        pr._ENTRY[pair]: 1}
    want = pr.prune_regrow_rows_plain(w, g, m, th)
    assert got[0].dtype == m.dtype and got[1].dtype == w.dtype
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[1]), _bits(want[1]))


def test_prune_regrow_kernel_refuses_pairs_it_has_no_entry_for(cuda_device):
    w, g, m = _pr_inputs(2, 100, 1, cuda_device)
    th = pr.sort_thresholds(w, g, m, 25, 12)
    launches, by_entry = pr.LAUNCHES, dict(pr.LAUNCHES_BY_ENTRY)
    for wdt, gdt, mdt in ((torch.float16, torch.float16, torch.float16),
                          (torch.bfloat16, torch.bfloat16, torch.float32),
                          (torch.float32, torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.float32, torch.int8)):
        with pytest.raises(TypeError, match="bfloat16, int8"):
            pr.prune_regrow_rows(w.to(wdt), g.to(gdt), m.to(mdt), th)
    assert pr.LAUNCHES == launches and pr.LAUNCHES_BY_ENTRY == by_entry


@pytest.mark.parametrize("k,n", [(4, 1000), (3, 3 * BLOCK_N + 5),
                                 (4, 2_359_296)])
@pytest.mark.parametrize("alpha", [1.0, 0.75])
def test_fold_rows_kernel_fp16_values_on_card(cuda_device, k, n, alpha):
    """fp16 stacked payload values (``pack_stacked(dtype=float16)``),
    widened exactly: bit-equal to the plain version, one launch."""
    num, den, words, values, nnz = _rows_inputs(k, n, n + k, cuda_device)
    values = values.to(torch.float16)
    launches, by_entry = pa.LAUNCHES_ROWS, dict(pa.LAUNCHES_BY_ENTRY)
    got = pa.packed_accum_rows(num.clone(), den.clone(), words, values, nnz,
                               alpha)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_ROWS == launches + 1
    assert _entry_launches(pa.LAUNCHES_BY_ENTRY, by_entry) == {
        "packed_accum_rows_f16": 1}
    want = pa.packed_accum_rows_plain(num.clone(), den.clone(), words, values,
                                      nnz, alpha)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("extra", [-1, 1])
def test_fold_rows_kernel_fp16_refuses_wrong_nnz(cuda_device, extra):
    """The refusal contract at fp16: a row whose bitmap disagrees with its
    nnz raises before anything is folded."""
    num, den, words, values, nnz = _rows_inputs(4, 3 * BLOCK_N, 7,
                                                cuda_device)
    values = values.to(torch.float16)
    bad = nnz.clone()
    bad[2] += extra
    num0, den0 = num.clone(), den.clone()
    launches, by_entry = pa.LAUNCHES_ROWS, dict(pa.LAUNCHES_BY_ENTRY)
    with pytest.raises(ValueError, match="set bits"):
        pa.packed_accum_rows(num, den, words, values, bad)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_ROWS == launches and pa.LAUNCHES_BY_ENTRY == by_entry
    assert torch.equal(num, num0) and torch.equal(den, den0)


def test_fold_rows_kernel_refuses_other_value_types(cuda_device):
    num, den, words, values, nnz = _rows_inputs(2, 1000, 3, cuda_device)
    launches = pa.LAUNCHES_ROWS
    for dtype in (torch.bfloat16, torch.float64):
        with pytest.raises(TypeError, match="float16"):
            pa.packed_accum_rows(num, den, words, values.to(dtype), nnz)
    assert pa.LAUNCHES_ROWS == launches


def test_lm_bf16_mask_update_step_on_card(cuda_device):
    """``make_mask_update_step`` on bf16 params with int8 masks: one
    (bf16, int8) prune/regrow launch per sparsifiable leaf, params stay
    bf16, every weight zero outside its new mask."""
    from repro_torch.configs import INPUT_SHAPES, SMOKE_ARCHS
    from repro_torch.launch import steps
    from repro_torch.models import bind
    from repro_torch.scale.stacked import default_threshold_sparsifiable
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_stack

    cfg = SMOKE_ARCHS["gemma3-1b"]
    api = bind(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = tree_stack([api.init(gen, torch.bfloat16) for _ in range(2)])
    masks = tree_map(
        lambda w: ((torch.rand(w.shape, generator=gen, device=cuda_device)
                    < 0.5) if default_threshold_sparsifiable(w)
                   else torch.ones(w.shape, dtype=torch.bool,
                                   device=cuda_device)).to(torch.int8),
        params)
    params = tree_map(lambda w, m: w * m.to(w.dtype), params, masks)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 2, 16), generator=gen,
                                     device=cuda_device),
             "labels": torch.randint(0, cfg.vocab, (2, 2, 16), generator=gen,
                                     device=cuda_device)}
    plan = steps.ScalePlan(cfg, INPUT_SHAPES["train_4k"], 2, 2,
                           torch.bfloat16)
    launches, by_entry = pr.LAUNCHES, dict(pr.LAUNCHES_BY_ENTRY)
    new_params, new_masks = steps.make_mask_update_step(api, plan)(
        params, masks, batch, 0.3)
    torch.cuda.synchronize()
    sparse = [x for x in tree_leaves(params)
              if default_threshold_sparsifiable(x)]
    assert sparse and pr.LAUNCHES - launches == len(sparse)
    assert _entry_launches(pr.LAUNCHES_BY_ENTRY, by_entry) == {
        "prune_regrow_rows_bf16_i8": len(sparse)}
    for w, w0, m in zip(tree_leaves(new_params), tree_leaves(params),
                        tree_leaves(new_masks)):
        assert w.dtype == w0.dtype and m.dtype == torch.int8
        assert bool(torch.all(w[m == 0] == 0))


@pytest.mark.parametrize("name,dtype", [("gemma3-1b", "fp32"),
                                        ("gemma3-1b", "bf16"),
                                        ("deepseek-moe-16b", "bf16"),
                                        ("mamba2-1.3b", "fp32")])
def test_dryrun_fake_trace_counts_equal_the_real_step_on_card(
        cuda_device, name, dtype):
    """The dry run's train step traced on ``cuda`` fake tensors and the
    same step run for real on the card, under the same counters
    (``utils.trace_cost``): FLOPs and bytes accessed equal (the
    counters' live-byte books too), at smoke width."""
    from repro_torch.configs import SMOKE_ARCHS, InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models import bind
    from repro_torch.utils.trace_cost import step_cost

    cfg = SMOKE_ARCHS[name]
    plan = dryrun.make_plan(cfg, InputShape("train_64", 64, 2, "train"), 2,
                            1, dtype)
    fake, _ = dryrun.trace_plan(plan, device="cuda")
    step, specs = dryrun.step_and_specs(bind(cfg), plan)
    args = dryrun.materialize(specs, cfg.vocab, cuda_device,
                              torch.Generator(device=cuda_device).manual_seed(0))
    _, real = step_cost(step, *args)
    torch.cuda.synchronize()
    assert fake.flops > 0
    assert (fake.flops, fake.bytes_accessed) == (real.flops,
                                                 real.bytes_accessed)
    assert (fake.argument_bytes, fake.output_bytes, fake.peak_live_bytes) == (
        real.argument_bytes, real.output_bytes, real.peak_live_bytes)


# ---------------------------------------------------------------------------
# the loop engine compiled: graphed against graph.disabled() from one state
# ---------------------------------------------------------------------------


def _loop_world(cuda_device, name, rounds, local_exec="loop", sim=None):
    """A K=4 smallcnn engine on the card (``SimEngine`` in ``sim`` mode
    when given), every test client with its own test-set size."""
    from repro_torch.data.loader import build_federated_image_task
    from repro_torch.fl.base import FLConfig, make_cnn_task
    from repro_torch.fl.engine import RoundEngine, make_strategy

    clients, _ = build_federated_image_task(
        0, n_clients=4, partition="pathological", n_train_per_class=24,
        n_test_per_client=16, hw=8)
    cfg = FLConfig(n_clients=4, rounds=rounds, local_epochs=1, batch_size=16,
                   degree=2)
    task = make_cnn_task("smallcnn", 10, 8, width=4, device=cuda_device)
    if sim is not None:
        from repro_torch.sim import SimEngine
        return SimEngine(make_strategy(name), task, clients, cfg, mode=sim,
                         local_exec=local_exec)
    return RoundEngine(make_strategy(name), task, clients, cfg,
                       local_exec=local_exec)


def _same_bits(a, b):
    """Equal dtypes and bits (-0.0 is not +0.0)."""
    if a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return torch.equal(a.view(as_int), b.view(as_int))
    return torch.equal(a, b)


def _captures(engine):
    return sum(g.captures for g in engine.task.graphs())


def _run_per_round(engine, eager):
    """Run ``engine`` to its end (eagerly under ``graph.disabled()``);
    per round its fold and gossip launches and its captures so far."""
    import contextlib

    from repro_torch.fl.engine import Callback
    from repro_torch.kernels import gossip_avg as ga
    from repro_torch.utils import graph

    rows = []

    class PerRound(Callback):
        def on_round_end(self, eng, metrics):
            rows.append((dict(pa.LAUNCHES_BY_ENTRY),
                         dict(ga.LAUNCHES_BY_ENTRY), _captures(eng)))

    engine.callbacks.append(PerRound())
    before = (dict(pa.LAUNCHES_BY_ENTRY), dict(ga.LAUNCHES_BY_ENTRY))
    with graph.disabled() if eager else contextlib.nullcontext():
        engine.run()
    torch.cuda.synchronize()
    out = []
    for fold, gossip, caps in rows:
        out.append(({e: n - before[0][e] for e, n in fold.items()},
                    {e: n - before[1][e] for e, n in gossip.items()}, caps))
        before = (fold, gossip)
    return out


def _graphed_against_eager(cuda_device, name, rounds, local_exec="loop"):
    from repro_torch.utils.tree import tree_leaves, tree_map

    eager = _loop_world(cuda_device, name, rounds, local_exec)
    start = tree_map(lambda x: x.clone(), eager.state)
    e_rows = _run_per_round(eager, eager=True)
    graphed = _loop_world(cuda_device, name, rounds, local_exec)
    graphed.state = tree_map(lambda x: x.clone(), start)
    g_rows = _run_per_round(graphed, eager=False)
    for a, b in zip(tree_leaves(graphed.state), tree_leaves(eager.state),
                    strict=True):
        assert _same_bits(a, b)
    assert graphed._acc_history == eager._acc_history
    assert graphed._comm == eager._comm and graphed._flops == eager._flops
    # launches per round equal eager's (the graphs hold no counted kernel:
    # the mix runs eagerly); captures stop growing after the first round
    assert [r[:2] for r in g_rows] == [r[:2] for r in e_rows]
    caps = [r[2] for r in g_rows]
    assert caps[0] > 0 and caps == [caps[0]] * rounds
    assert all(r[2] == 0 for r in e_rows)
    return graphed, g_rows


@pytest.mark.parametrize("name", ["dispfl", "dispfl_anneal"])
def test_loop_engine_graphed_equals_eager(cuda_device, name):
    graphed, rows = _graphed_against_eager(cuda_device, name, 3)
    assert sum(rows[0][0].values()) > 0 and sum(rows[0][1].values()) > 0
    ((_, stacked), step), = graphed.task._steps.items()
    assert not stacked and step.captures == 1 and step.replays > 0


def test_vmap_phase_graphed_equals_eager(cuda_device):
    graphed, _ = _graphed_against_eager(cuda_device, "dispfl", 3, "vmap")
    ((_, stacked), step), = graphed.task._steps.items()
    # one capture of the stacked step, replayed every step of every phase
    assert stacked and step.captures == 1 and step.replays > 3


def test_async_sim_vmap_captures_do_not_depend_on_step_count(cuda_device):
    """The asynchronous simulator at the default ``local_exec="auto"`` runs
    the vmap step one client a phase; on dirichlet shards of ragged sizes
    it captures once per batch size, not once per phase length, and stays
    bit-equal to the same run under ``graph.disabled()``."""
    import contextlib

    from repro_torch.data.loader import build_federated_image_task
    from repro_torch.fl.base import FLConfig, make_cnn_task
    from repro_torch.fl.engine import make_strategy
    from repro_torch.sim import SimEngine
    from repro_torch.utils import graph
    from repro_torch.utils.tree import tree_leaves, tree_map

    clients, _ = build_federated_image_task(
        0, n_clients=4, partition="dirichlet", alpha=0.5,
        n_train_per_class=24, n_test_per_client=16, hw=8)
    cfg = FLConfig(n_clients=4, rounds=3, local_epochs=1, batch_size=16,
                   degree=2)
    bss = {min(cfg.batch_size, c.n_train) for c in clients}
    steps = {-(-c.n_train // min(cfg.batch_size, c.n_train))
             for c in clients}
    assert len(steps) > len(bss)          # phases of several lengths
    runs, start = [], None
    for eager in (True, False):
        eng = SimEngine(make_strategy("dispfl"),
                        make_cnn_task("smallcnn", 10, 8, width=4,
                                      device=cuda_device),
                        clients, cfg, mode="async", staleness=2)
        if start is None:
            start = tree_map(lambda x: x.clone(), eng.state)
        else:
            eng.state = tree_map(lambda x: x.clone(), start)
        with graph.disabled() if eager else contextlib.nullcontext():
            eng.run()
        runs.append(eng)
    eager, graphed = runs
    ((_, stacked), step), = graphed.task._steps.items()
    assert stacked and step.captures == len(bss)
    assert step.replays > step.captures
    assert graphed._acc_history == eager._acc_history
    for a, b in zip(tree_leaves(graphed.state), tree_leaves(eager.state),
                    strict=True):
        assert _same_bits(a, b)


@pytest.mark.parametrize("name", ["dpsgd", "ditto", "fomo", "dfedalt",
                                  "dfedsam", "subfedavg"])
def test_strategy_graphed_equals_eager(cuda_device, name):
    _graphed_against_eager(cuda_device, name, 2)


def test_sync_sim_graphed_equals_round_engine(cuda_device):
    from repro_torch.utils.tree import tree_leaves, tree_map

    sim = _loop_world(cuda_device, "dispfl", 2, sim="sync")
    eng = _loop_world(cuda_device, "dispfl", 2)
    eng.state = tree_map(lambda x: x.clone(), sim.state)
    sim.run(), eng.run()
    assert _captures(sim) > 0 and _captures(eng) > 0
    assert sim._acc_history == eng._acc_history
    for a, b in zip(tree_leaves(sim.state), tree_leaves(eng.state),
                    strict=True):
        assert _same_bits(a, b)


def test_tree_fold_refusal_on_card(cuda_device):
    """A malformed leaf inside a payload tree: ``decode_tree``,
    ``packed_gossip_one`` and ``packed_accum_all`` raise before any fold —
    accumulators and ``LAUNCHES`` unchanged — and the same folds without it
    equal their plain versions."""
    from repro_torch.sparse import ops
    from repro_torch.sparse.packed import PackedSparse, pack_tree
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    shapes = {"a": (3, 3, 16, 32), "b": (1000,), "c": (17, 10)}
    w = {k: torch.randn(s, generator=gen, device=cuda_device)
         for k, s in shapes.items()}
    m = {k: (torch.rand(s, generator=gen, device=cuda_device) < 0.4).float()
         for k, s in shapes.items()}
    w = {k: w[k] * m[k] for k in w}
    is_p = lambda p: isinstance(p, PackedSparse)  # noqa: E731
    leaves = tree_leaves(pack_tree(w, m), is_leaf=is_p)
    leaves[1] = PackedSparse(leaves[1].bitmap, leaves[1].values[:-1],
                             leaves[1].shape)
    bad = tree_unflatten_like(w, leaves)
    launches = pa.LAUNCHES
    for call in (lambda: ops.decode_tree(bad),
                 lambda: ops.packed_gossip_one(w, m, [bad])):
        with pytest.raises(ValueError, match="set bits"):
            call()
    folds = [(torch.randn(p.n_coords, generator=gen, device=cuda_device),
              torch.rand(p.n_coords, generator=gen, device=cuda_device),
              p.bitmap, p.values, 0.75) for p in leaves]
    before = [(f[0].clone(), f[1].clone()) for f in folds]
    with pytest.raises(ValueError, match="set bits"):
        pa.packed_accum_all(folds)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == launches
    for f, (n0, d0) in zip(folds, before):
        assert torch.equal(f[0], n0) and torch.equal(f[1], d0)
    good = [folds[0], folds[2]]
    pa.packed_accum_all(good)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == launches + 2
    for f, (n0, d0) in zip(good, [before[0], before[2]]):
        want = pa.packed_accum_plain(n0, d0, *f[2:])
        assert torch.equal(f[0], want[0]) and torch.equal(f[1], want[1])


# ---------------------------------------------------------------------------
# the serving path compiled: pool-wide forwards and the slot write as CUDA
# graphs, captured in ``ServeEngine.warmup()``
# ---------------------------------------------------------------------------

SERVE_GRAPH_CASES = [("mlp", "vmap"), ("mlp", "ref"), ("mlp", "kernel"),
                     ("smallcnn", "vmap"), ("gemma3-1b", "vmap"),
                     ("qwen3-moe-30b-a3b", "vmap"), ("mamba2-1.3b", "vmap"),
                     ("jamba-1.5-large-398b", "vmap"),
                     ("llava-next-mistral-7b", "vmap"),
                     ("seamless-m4t-large-v2", "vmap")]


def _serve_world(cuda_device, name, seed=0, model=None):
    """A fresh model (or ``model``) and a store on the card (users drawn on
    the CPU from seeds, as the serving CLI draws them): 6 users, 3 slots."""
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.core.masks import apply_mask, init_mask
    from repro_torch.fl.base import make_cnn_task
    from repro_torch.serve import ArchModel, MLPModel, ModelStore, TaskModel
    from repro_torch.utils.tree import tree_map

    if model is not None:
        pass
    elif name == "mlp":
        model = MLPModel(d_in=64, widths=(128, 128), n_out=32, rows=4)
    elif name == "smallcnn":
        model = TaskModel(make_cnn_task("smallcnn", 10, 8, width=4,
                                        device="cpu"), hw=8)
    else:
        model = ArchModel(SMOKE_ARCHS[name], prompt_len=4)
    to = lambda t: tree_map(lambda x: x.to(cuda_device), t)  # noqa: E731
    store = ModelStore(to(model.init(torch.Generator().manual_seed(seed))),
                       cache_size=3)
    gen = torch.Generator().manual_seed(seed + 1)
    for u in range(6):
        p = model.init(gen)
        m = init_mask(gen, p, 0.5)
        store.put(u, to(apply_mask(p, m)), to(m))
    return model, store


def _serve_on_card(cuda_device, name, backend, eager):
    """Serve one request stream (``warmup()`` called first, on its own);
    returns the result, store, model, the captures ``warmup()`` took and
    the masked-matmul launches of warmup and serving."""
    import contextlib

    from repro_torch.serve import RequestStream, ServeEngine
    from repro_torch.utils import graph

    model, store = _serve_world(cuda_device, name)
    engine = ServeEngine(store, model, backend=backend, max_batch=3)
    reqs = RequestStream(n_users=6, n_requests=24, seed=3).requests()
    launches = mmk.LAUNCHES
    with graph.disabled() if eager else contextlib.nullcontext():
        engine.warmup()
        warm = [g.captures for g in model.graphs()]
        res = engine.serve(reqs, warmup=False)
    torch.cuda.synchronize()
    assert [g.captures for g in model.graphs()] == warm
    return res, store, model, warm, mmk.LAUNCHES - launches


@pytest.mark.parametrize("name,backend", SERVE_GRAPH_CASES)
def test_serving_graphed_equals_eager_on_card(cuda_device, name, backend):
    """Graphed serving is bit-equal to the same serving under
    ``graph.disabled()`` (outputs and cache counters); ``warmup()`` takes
    exactly one capture of the forward, and serving takes none; the
    kernel backend launches the masked matmul
    3 x (batches + 2) times (the capturing call's eager warm-up and its
    replay, then one replay a batch), eagerly 3 x (batches + 1)."""
    res_g, st_g, model_g, warm_g, mm_g = _serve_on_card(
        cuda_device, name, backend, eager=False)
    res_e, st_e, model_e, warm_e, mm_e = _serve_on_card(
        cuda_device, name, backend, eager=True)
    assert warm_g == [1] and warm_e == [0]
    (fwd,) = model_g.graphs()
    assert fwd.replays == res_g.summary["batches"] + 1
    assert sorted(res_g.outputs) == sorted(res_e.outputs)
    for rid, y in res_g.outputs.items():
        assert np.isfinite(y).all()
        assert np.array_equal(y.view(np.int32),
                              res_e.outputs[rid].view(np.int32))
    assert st_g.stats() == st_e.stats() and st_g.evictions > 0
    batches = res_g.summary["batches"]
    if backend == "kernel":
        assert (mm_g, mm_e) == (3 * (batches + 2), 3 * (batches + 1))
    else:
        assert mm_g == mm_e == 0


@pytest.mark.parametrize("name,backend", [("mlp", "kernel"),
                                          ("gemma3-1b", "vmap")])
def test_serving_graph_reads_the_store_pool_in_place(cuda_device, name,
                                                     backend):
    """The forward's capture takes the store's own pool tensors as its
    static inputs (``data_ptr`` equal), and the request inputs as a copy.
    A second store of the same shapes on the same model, as the
    reference's ``tests/test_serve.py`` serves two, gets a capture of its
    own in its ``warmup()``, reading its own pool in place, and both
    stores serve on, interleaved, bit-equal to ``graph.disabled()``; the
    first store's pool is never written."""
    from repro_torch.serve import RequestStream, ServeEngine
    from repro_torch.utils import graph
    from repro_torch.utils.tree import tree_leaves, tree_map

    res, store, model, _, _ = _serve_on_card(cuda_device, name, backend,
                                             eager=False)
    (fwd,) = model.graphs()
    (cap,) = fwd.captured()

    def pool_of(st):
        pool = tree_leaves(st.pool_params)
        return pool + (tree_leaves(st.pool_masks) if name == "mlp" else [])

    def reads_in_place(cap, st):
        static = [x for x in cap.inputs if x is not None]
        # the arguments' leaves in order: the pool's, then the inputs' one
        pool = pool_of(st)
        return (len(static) == len(pool) + 1
                and [x.data_ptr() for x in static[:-1]]
                == [x.data_ptr() for x in pool]
                and static[-1].data_ptr() not in
                {x.data_ptr() for x in pool})

    assert reads_in_place(cap, store)
    reqs = RequestStream(n_users=6, n_requests=8, seed=4).requests()
    stores = {"A": store, "B": _serve_world(cuda_device, name, seed=7,
                                            model=model)[1]}
    engines = {k: ServeEngine(st, model, backend=backend, max_batch=3)
               for k, st in stores.items()}
    got = []
    for k in "ABA":
        before = {o: tree_map(torch.clone, st._pool)
                  for o, st in stores.items() if o != k}
        got.append(engines[k].serve(reqs).outputs)
        torch.cuda.synchronize()
        for o, pool in before.items():
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(stores[o]._pool), tree_leaves(pool)))
    assert fwd.captures == 2 and len(fwd.captured()) == 2
    assert reads_in_place(fwd.captured()[1], stores["B"])
    with graph.disabled():
        solo = {k: ServeEngine(_serve_world(cuda_device, name, seed=s)[1],
                               model, backend=backend, max_batch=3)
                for k, s in (("A", 0), ("B", 7))}
        solo["A"].serve(RequestStream(n_users=6, n_requests=24,
                                      seed=3).requests())
        want = [solo[k].serve(reqs).outputs for k in "ABA"]
    for outs, ref in zip(got, want):
        assert sorted(outs) == sorted(ref)
        for rid, y in outs.items():
            assert np.isfinite(y).all()
            assert np.array_equal(y.view(np.int32), ref[rid].view(np.int32))


@pytest.mark.parametrize("name,backend", [("mlp", "kernel"), ("mlp", "vmap"),
                                          ("gemma3-1b", "vmap")])
def test_serving_two_stores_on_one_model_equal_eager(cuda_device, name,
                                                     backend):
    """Two stores of the same shapes on one model (``MLPModel`` on the
    kernel and vmap backends, an ``ArchModel``), served A, B, A: one
    capture a store, taken in its ``warmup()`` (the second with no eager
    warm-up), none while serving, each capture's graph-pool bytes
    recorded, and every output bit-equal to the same stores served A, B,
    A under ``graph.disabled()``."""
    from repro_torch.serve import RequestStream, ServeEngine
    from repro_torch.utils import graph

    reqs = RequestStream(n_users=6, n_requests=16, seed=3).requests()
    runs = {}
    for mode in ("graphed", "eager"):
        model, a = _serve_world(cuda_device, name, seed=0)
        b = _serve_world(cuda_device, name, seed=7, model=model)[1]
        engines = {"A": ServeEngine(a, model, backend=backend, max_batch=3),
                   "B": ServeEngine(b, model, backend=backend, max_batch=3)}
        with graph.disabled() if mode == "eager" else contextlib.nullcontext():
            engines["A"].warmup()
            launches = mmk.LAUNCHES
            engines["B"].warmup()
            if backend == "kernel" and mode == "graphed":
                # B's capture runs no eager warm-up: one replay, 3 layers
                assert mmk.LAUNCHES - launches == 3
            warm = [g.captures for g in model.graphs()]
            runs[mode] = [engines[k].serve(reqs, warmup=False).outputs
                          for k in "ABA"]
        torch.cuda.synchronize()
        assert [g.captures for g in model.graphs()] == warm
        if mode == "graphed":
            (fwd,) = model.graphs()
            assert fwd.captures == 2 and len(fwd.pool_bytes()) == 2
            assert all(n >= 0 for n in fwd.pool_bytes())
            fwd.release()
    for outs, ref in zip(runs["graphed"], runs["eager"]):
        assert sorted(outs) == sorted(ref)
        for rid, y in outs.items():
            assert np.array_equal(y.view(np.int32), ref[rid].view(np.int32))
    assert not np.array_equal(runs["graphed"][0][0], runs["graphed"][1][0])


def test_serving_refuses_a_pool_no_capture_holds(cuda_device):
    """Outside a warm-up, a forward given a pool of the captured shapes
    that no capture holds raises with the read-in-place message, takes no
    capture and writes neither pool."""
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.tree import tree_leaves, tree_map

    model, a = _serve_world(cuda_device, "mlp", seed=0)
    b = _serve_world(cuda_device, "mlp", seed=7, model=model)[1]
    ServeEngine(a, model, backend="kernel", max_batch=3).warmup()
    (fwd,) = model.graphs()
    for u in range(3):
        b.acquire(u)
    before = tree_map(torch.clone, b._pool)
    xs = torch.from_numpy(np.stack([model.make_input(u) for u in range(3)]
                                   )).to(cuda_device)
    with pytest.raises(ValueError, match="read in place"):
        model.batched_forward(b.pool_params, b.pool_masks, xs,
                              backend="kernel")
    torch.cuda.synchronize()
    assert fwd.captures == 1
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(b._pool),
                                                 tree_leaves(before)))
    y = model.batched_forward(a.pool_params, a.pool_masks, xs,
                              backend="kernel")
    assert fwd.captures == 1 and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("payload", [np.float32, np.float16])
def test_serving_store_refuses_a_miscounted_frame_on_card(cuda_device,
                                                           payload):
    """A frame whose bitmap holds one bit fewer than its header's nnz
    raises in the miss's scan on the card, before a slot is chosen:
    ``stats()`` gains the miss only, every user's residency and every
    slot's contents stay as they were, and the good frame then serves."""
    from repro_torch.core.accounting import HEADER_NBYTES
    from repro_torch.core.masks import apply_mask, init_mask
    from repro_torch.serve import MLPModel, ModelStore
    from repro_torch.utils.tree import tree_leaves, tree_map

    model = MLPModel(d_in=64, widths=(128, 128), n_out=32, rows=4)
    to = lambda t: tree_map(lambda x: x.to(cuda_device), t)  # noqa: E731
    store = ModelStore(to(model.init(torch.Generator().manual_seed(0))),
                       cache_size=2, payload_dtype=payload)
    gen = torch.Generator().manual_seed(1)
    for u in range(3):
        p = model.init(gen)
        m = init_mask(gen, p, 0.5)
        store.put(u, to(apply_mask(p, m)), to(m))
    store.acquire(0), store.acquire(1)
    good = bytearray(store.frame(2))
    i = next(i for i in range(HEADER_NBYTES, len(good)) if good[i])
    bad = bytearray(good)
    bad[i] &= bad[i] - 1
    store._frames[2] = bytes(bad)
    before, pool = store.stats(), tree_map(torch.clone, store._pool)
    with pytest.raises(ValueError, match="frame carries"):
        store.acquire(2)
    torch.cuda.synchronize()
    after = store.stats()
    assert after == {**before, "misses": before["misses"] + 1}
    assert [store.resident(u) for u in range(3)] == [True, True, False]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(store._pool),
                                                 tree_leaves(pool)))
    store._frames[2] = bytes(good)
    slot = store.acquire(2)
    assert store.evictions == 1 and store.resident(2)
    assert bool(torch.isfinite(store.pool_params["layer0"]["w"][slot]).all())
