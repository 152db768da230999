"""The port's two kernels: plain PyTorch versions against the reference's
Pallas kernels (interpret mode) and oracles, on the CPU.  The CUDA kernels
are held against these plain versions on the card in
tests/test_torch_cuda.py.

Tolerances: fp32 gossip is exact against ``gossip_average_one`` (same
sequential order) and within 1e-5 of ``gossip_avg_flat`` (which sums with
``jnp.sum``); bf16 within 2e-2.  The fold is exact for den and for num at
alpha=1, within 1e-6 at alpha=0.75 (the jitted Pallas kernel may fuse the
multiply-add, see tests/test_sparse.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gossip import gossip_average_one as ref_gossip_one
from repro.kernels.gossip_avg import gossip_avg_flat
from repro.kernels.packed_accum import BLOCK_N, packed_accum_flat
from repro.kernels.ref import packed_accum_ref
from repro.sparse.packed import _pack_bits, _unpack_bits, n_words
from repro_torch.kernels.gossip_avg import gossip_avg
from repro_torch.kernels.packed_accum import packed_accum
from repro_torch.sparse.packed import words_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1


def _gossip_inputs(j, n, seed):
    rng = np.random.default_rng(seed)
    m = (rng.random((j, n)) < 0.5).astype(np.float32)
    w = (rng.normal(size=(j, n)) * m).astype(np.float32)
    return w, m


@pytest.mark.parametrize("j", [1, 3, 7])
@pytest.mark.parametrize("n", [128, 1000, 5000])
def test_gossip_plain_fp32_matches_reference(j, n):
    w, m = _gossip_inputs(j, n, j * 100 + n)
    got = gossip_avg(list(torch.from_numpy(w)), list(torch.from_numpy(m)),
                     torch.from_numpy(m[0])).numpy()
    exact = np.asarray(ref_gossip_one(jnp.asarray(w[0]), jnp.asarray(m[0]),
                                      [jnp.asarray(x) for x in w[1:]],
                                      [jnp.asarray(x) for x in m[1:]]))
    np.testing.assert_array_equal(got, exact)
    pallas = np.asarray(gossip_avg_flat(jnp.asarray(w), jnp.asarray(m),
                                        jnp.asarray(m[0])))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("j", [1, 3, 7])
@pytest.mark.parametrize("n", [128, 1000, 5000])
def test_gossip_plain_bf16_matches_pallas(j, n):
    w, m = _gossip_inputs(j, n, j * 100 + n + 1)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    mb = torch.from_numpy(m).to(torch.bfloat16)
    got = gossip_avg(list(wb), list(mb), mb[0])
    assert got.dtype == torch.bfloat16
    pallas = gossip_avg_flat(jnp.asarray(wb.float().numpy(), jnp.bfloat16),
                             jnp.asarray(m, jnp.bfloat16),
                             jnp.asarray(m[0], jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_gossip_assumes_masked_rows():
    # rows are summed as given: an unmasked neighbour is NOT re-masked, which
    # is why every caller must hand in w ⊙ m (the Pallas kernel assumes it too)
    w = torch.tensor([[1.0, 2.0], [4.0, 8.0]])
    m = torch.tensor([[1.0, 1.0], [1.0, 0.0]])
    got = gossip_avg(list(w), list(m), m[0])
    np.testing.assert_array_equal(got.numpy(), [2.5, 10.0])
    masked = gossip_avg(list(w * m), list(m), m[0])
    np.testing.assert_array_equal(masked.numpy(), [2.5, 2.0])


def test_gossip_wrapper_rejects_bad_input():
    a = torch.zeros(4)
    with pytest.raises(ValueError):
        gossip_avg([a, torch.zeros(5)], [a, a], a)
    with pytest.raises(TypeError):
        gossip_avg([a.double()], [a.double()], a.double())
    with pytest.raises(ValueError):
        gossip_avg([a] * 33, [a] * 33, a)


def _fold_inputs(n, density, seed):
    rng = np.random.default_rng(seed)
    flags = rng.random(n) < density
    values = rng.normal(size=int(flags.sum())).astype(np.float32)
    num0 = rng.normal(size=n).astype(np.float32)
    den0 = rng.random(n).astype(np.float32)
    return flags, values, num0, den0


@pytest.mark.parametrize("n", [3 * BLOCK_N, 1000, 5000])
@pytest.mark.parametrize("alpha", [1.0, 0.75])
def test_fold_plain_matches_pallas_and_oracle(n, alpha):
    flags, values, num0, den0 = _fold_inputs(n, 0.3, n)
    words_u32 = _pack_bits(flags)
    num, den = packed_accum(torch.from_numpy(num0.copy()),
                            torch.from_numpy(den0.copy()),
                            words_from_numpy(words_u32),
                            torch.from_numpy(values), alpha)
    num_r, den_r = packed_accum_ref(jnp.asarray(num0), jnp.asarray(den0),
                                    jnp.asarray(flags), jnp.asarray(values),
                                    alpha)
    # the Pallas kernel wants whole blocks and a padded value window
    pad = (-n) % BLOCK_N
    words_pad = np.zeros((n + pad) // 32, np.uint32)
    words_pad[: n_words(n)] = words_u32
    pc = _unpack_bits(words_pad, n + pad).reshape(-1, BLOCK_N).sum(axis=1)
    offsets = np.concatenate([[0], np.cumsum(pc)[:-1]]).astype(np.int32)
    num_k, den_k = packed_accum_flat(
        jnp.pad(jnp.asarray(num0), (0, pad)), jnp.pad(jnp.asarray(den0), (0, pad)),
        jnp.asarray(words_pad),
        jnp.asarray(np.concatenate([values, np.zeros(BLOCK_N, np.float32)])),
        jnp.asarray(offsets), jnp.float32(alpha))
    np.testing.assert_array_equal(den.numpy(), np.asarray(den_r))
    np.testing.assert_array_equal(den.numpy(), np.asarray(den_k)[:n])
    if alpha == 1.0:
        np.testing.assert_array_equal(num.numpy(), np.asarray(num_r))
        np.testing.assert_array_equal(num.numpy(), np.asarray(num_k)[:n])
    else:
        np.testing.assert_allclose(num.numpy(), np.asarray(num_r),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(num.numpy(), np.asarray(num_k)[:n],
                                   rtol=1e-6, atol=1e-6)


def test_fold_wrapper_rejects_bad_input():
    n = 100
    num, den = torch.zeros(n), torch.zeros(n)
    words = torch.zeros(n_words(n), dtype=torch.int32)
    with pytest.raises(ValueError):
        packed_accum(num, den, words[:-1], torch.zeros(0))
    with pytest.raises(TypeError):
        packed_accum(num.double(), den, words, torch.zeros(0))
    with pytest.raises(TypeError):
        packed_accum(num, den, words, torch.zeros(0, dtype=torch.float64))
    # the bitmap's set bits and the values must agree in number, both ways
    words[0] = 0b101
    for k in (1, 3):
        with pytest.raises(ValueError, match="2 set bits"):
            packed_accum(num, den, words, torch.zeros(k))
