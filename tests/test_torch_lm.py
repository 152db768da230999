"""The port's LM families (``repro_torch.configs``, ``repro_torch.models``)
against the JAX reference (``repro.configs``, ``repro.models``) on the CPU.

Weights cannot be replayed across ``jax.random`` and ``torch.Generator``,
so every comparison carries the reference's params across as numpy arrays
(``checkpoint.npz.tree_from_numpy``).  Configs, layer plans, leaf paths,
shapes, dtypes and ERK densities are equal.  The prefill's logits and
caches, ``moe_apply``, ``_ssd_chunked`` and ``_sdpa`` agree to 1e-5 at the
scale of the tensor: ``max|port - ref| <= 1e-5 * max(1, max|ref|)``.  An
absolute 1e-5 cannot hold everywhere: the tied-embedding logits have a
standard deviation of 16 (an N(0, 1) table against a unit-RMS state), and
one K=256 fp32 dot product at that size rounds by ~1.5e-5 whichever order
sums it (XLA's or MKL's); the MoE outputs reach ~120 (the reference's
``lecun_init`` takes fan_in = n_experts for the expert stacks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.masks import erk_densities_for_params as ref_erk
from repro.models import attention as ref_attn
from repro.models import bind as ref_bind
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models.common import apply_rope as ref_rope
from repro.models.common import rmsnorm as ref_rmsnorm
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch import configs
from repro_torch.checkpoint.npz import tree_from_numpy
from repro_torch.core.masks import erk_densities_for_params
from repro_torch.models import attention as attn
from repro_torch.models import bind
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.common import activation, apply_rope, rmsnorm
from repro_torch.utils.tree import tree_leaves_with_path

pytestmark = pytest.mark.tier1

TOL = 1e-5
ARCHS = sorted(configs.SMOKE_ARCHS)
PROMPT = 4
ROWS = 2



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run eager forwards of tiny models, hundreds of small ops
    each; under the suite's parallel workers torch's intra-op threads only
    contend for the cores, so the module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_close(got, want, what=""):
    """``max|got - want| <= TOL * max(1, max|want|)``, shapes equal."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: max abs err {err} > {TOL} x {scale}"


def _assert_close_trees(ref_tree, port_tree, what):
    ra, pa = ref_leaves(ref_tree), tree_leaves_with_path(port_tree)
    assert [p for p, _ in ra] == [p for p, _ in pa], what
    for (path, x), (_, y) in zip(ra, pa):
        assert_close(y, x, f"{what} {path}")


def _batch(cfg, tokens):
    """The serving path's prefill batch: zero prefix (VLM) / frames (audio)."""
    b = tokens.shape[0]
    batch, kw = {"tokens": tokens}, {}
    if cfg.prefix_len:
        batch["prefix"] = np.zeros((b, cfg.prefix_len, cfg.d_model), np.float32)
    if cfg.enc_layers:
        batch["frames"] = np.zeros((b, 8, cfg.d_model), np.float32)
        kw["enc_len"] = 8
    return batch, kw


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """One smoke arch: the reference's params and prefill (logits, cache) at
    ROWS x PROMPT tokens, built once."""
    name = request.param
    cfg = ref_configs.SMOKE_ARCHS[name]
    api = ref_bind(cfg, remat=False)
    params = api.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (ROWS, PROMPT)).astype(np.int32)
    batch, kw = _batch(cfg, tokens)
    cache = api.init_cache(ROWS, PROMPT + cfg.prefix_len, **kw)
    logits, new_cache = jax.jit(api.prefill)(
        params, jax.tree.map(jnp.asarray, batch), cache)
    return {"name": name, "cfg": cfg, "params": _np(params), "batch": batch,
            "kw": kw, "logits": np.asarray(logits), "cache": _np(new_cache)}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_configs_and_layer_plans_match_reference():
    for table, ref_table in ((configs.ARCHS, ref_configs.ARCHS),
                             (configs.SMOKE_ARCHS, ref_configs.SMOKE_ARCHS)):
        assert sorted(table) == sorted(ref_table)
        for name, cfg in table.items():
            ref = ref_table[name]
            assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
            assert ([dataclasses.asdict(s) for s in configs.layer_kinds(cfg)]
                    == [dataclasses.asdict(s)
                        for s in ref_configs.layer_kinds(ref)]), name
            assert lm.layer_plan(cfg)[:4] == ref_lm.layer_plan(ref)[:4], name
    for name in configs.ARCHS:
        assert configs.get_arch(name) is configs.ARCHS[name]
        assert configs.get_arch(name, smoke=True) is configs.SMOKE_ARCHS[name]
        assert (configs.base.pattern_period(configs.ARCHS[name])
                == ref_configs.base.pattern_period(ref_configs.ARCHS[name]))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("nope")


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def test_init_tree_matches_reference(arch):
    port = bind(configs.SMOKE_ARCHS[arch["name"]]).init(
        torch.Generator().manual_seed(0))
    ra, pa = ref_leaves(arch["params"]), tree_leaves_with_path(port)
    assert [p for p, _ in ra] == [p for p, _ in pa]
    for (path, x), (_, y) in zip(ra, pa):
        assert tuple(x.shape) == tuple(y.shape), path
        assert y.dtype == torch.float32 and x.dtype == np.float32, path
        assert torch.isfinite(y).all(), path


def test_erk_densities_match_reference(arch):
    port = tree_from_numpy(arch["params"])
    for density in (0.5, 0.1):
        assert (erk_densities_for_params(port, density)
                == ref_erk(arch["params"], density))


def test_prefill_matches_reference(arch):
    cfg = configs.SMOKE_ARCHS[arch["name"]]
    api = bind(cfg)
    batch = tree_from_numpy(arch["batch"])
    cache = api.init_cache(ROWS, PROMPT + cfg.prefix_len, **arch["kw"])
    logits, new_cache = api.prefill(tree_from_numpy(arch["params"]), batch,
                                    cache)
    assert logits.shape == arch["logits"].shape == (ROWS, 1, cfg.vocab)
    assert_close(logits, arch["logits"], "logits")
    _assert_close_trees(arch["cache"], new_cache, "cache")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _moe_case(capacity_factor):
    cfg = configs.SMOKE_ARCHS["qwen3-moe-30b-a3b"]
    spec = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    ref_spec = dataclasses.replace(ref_configs.SMOKE_ARCHS[
        "qwen3-moe-30b-a3b"].moe, capacity_factor=capacity_factor)
    params = _np(ref_moe.moe_init(jax.random.PRNGKey(1), cfg.d_model,
                                  ref_spec, jnp.float32))
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    return spec, ref_spec, params, x


@pytest.mark.parametrize("capacity_factor,drops", [(1.25, False), (0.25, True)],
                         ids=["no-drop", "drop"])
def test_moe_apply_matches_oracle_and_reference(capacity_factor, drops):
    spec, ref_spec, params, x = _moe_case(capacity_factor)
    want, want_aux = ref_moe.moe_apply(params, jnp.asarray(x), ref_spec)
    tp, tx = tree_from_numpy(params), torch.from_numpy(x)
    got, aux = moe.moe_apply(tp, tx, spec)
    assert_close(got, want, "moe_apply")
    assert_close(aux, want_aux, "aux")
    oracle, oracle_aux = moe.moe_dense_ref(tp, tx, spec)
    ref_oracle, _ = ref_moe.moe_dense_ref(params, jnp.asarray(x), ref_spec)
    assert_close(oracle, ref_oracle, "moe_dense_ref")
    assert float(oracle_aux) == float(aux)
    # tokens are dropped exactly when the capacity is below the busiest
    # expert's load; then the dispatch departs from the oracle
    n = x.shape[0] * x.shape[1]
    _, eids, _ = moe._route(tp, tx.reshape(n, -1), spec)
    load = int(moe._expert_counts(eids, spec.n_experts).max())
    assert (load > moe.capacity_for(n, spec)) == drops
    if drops:
        with pytest.raises(AssertionError):
            assert_close(got, oracle.numpy())
    else:
        assert_close(got, oracle.numpy(), "moe_apply vs oracle")


def test_moe_top_k_breaks_ties_toward_lower_index():
    spec = configs.MoESpec(n_experts=4, top_k=2, d_expert=8)
    params = {"router": torch.zeros((3, 4))}            # all probs equal
    gates, eids, _ = moe._route(params, torch.ones((5, 3)), spec)
    assert eids.tolist() == [[0, 1]] * 5
    ref_gates, ref_eids, _ = ref_moe._route(
        {"router": jnp.zeros((3, 4))}, jnp.ones((5, 3)), spec)
    assert np.asarray(ref_eids).tolist() == eids.tolist()
    np.testing.assert_array_equal(gates.numpy(), np.asarray(ref_gates))


def test_ssd_chunked_matches_reference_over_chunks():
    rng = np.random.default_rng(4)
    b, l, h, p, n, chunk = 2, 32, 3, 8, 16, 8              # 4 chunks
    xh = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((b, l, h))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    want_y, want_s = ref_ssm._ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)),
                                          chunk)
    y, s = ssm._ssd_chunked(*map(torch.from_numpy, (xh, dt, a, bm, cm)), chunk)
    assert_close(y, want_y, "y")
    assert_close(s, want_s, "final state")
    with pytest.raises(ValueError, match="not divisible"):
        ssm._ssd_chunked(*map(torch.from_numpy, (xh, dt, a, bm, cm)), 12)


def test_softplus_is_logaddexp_beyond_torch_threshold():
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_allclose(ssm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("h,hkv,window", [(4, 1, 0), (4, 2, 5), (4, 4, 3)],
                         ids=["mqa", "gqa-window", "mha-window"])
def test_sdpa_matches_reference(h, hkv, window):
    cfg = configs.SMOKE_ARCHS["qwen3-8b"]
    rng = np.random.default_rng(h * 10 + hkv + window)
    b, s, dh = 2, 12, 16
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    mask = attn.causal_mask(s, s, 0, window)
    ref_mask = ref_attn.causal_mask(s, s, 0, window)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    want = ref_attn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          cfg, ref_mask)
    got = attn._sdpa(*map(torch.from_numpy, (q, k, v)), cfg, mask)
    assert_close(got, want, "sdpa")


def test_norm_rope_and_gelu_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    assert_close(
        rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
        ref_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)), "rmsnorm")
    pos = np.broadcast_to(np.arange(6)[None] + 1000, (2, 6)).copy()
    for theta in (10000.0, 1_000_000.0):
        assert_close(
            apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
            ref_rope(jnp.asarray(x), jnp.asarray(pos), theta), "rope")
    assert_close(activation("gelu")(torch.from_numpy(x)),
                 jax.nn.gelu(jnp.asarray(x), approximate=True), "gelu")
