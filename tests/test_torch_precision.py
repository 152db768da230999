"""The port's reduced-precision surface against the JAX reference on the
CPU: ``DTypePolicy``, the bf16 weight carrier, the bf16 step builders,
the kernels' bf16/fp16 plain versions against the reference's Pallas
kernels (interpret mode), fp16 stacked payloads and the fp16 store.

Inputs are made with numpy (bf16 through ``ml_dtypes``, the reference's
bf16 array type) and handed to both packages.

Tolerances:

* exact: the carrier, ``DTypePolicy``, prune/regrow for every (weight,
  mask) pair (the Pallas body widens to fp32 and compares, as the plain
  version does), ``pack_stacked(dtype=float16)``, the fp16 row fold,
  the fp16 store's frames, sizes and unpacked models, and the threshold
  mask update on the reference's own gradients;
* the bf16 masked matmul's plain version against ``ops.masked_matmul``:
  the reference's own bf16 sweep tolerance (``tests/test_kernels.py``:
  rtol 5e-2, atol 5e-2 * sqrt(K));
* the bf16 train step (``_FakeMesh`` plan of ``tests/test_scale_steps.py``,
  qwen3-8b's smoke config cut to two layers, lr ``STEP_LR``): losses
  within 2^-8 relative; the gossip alone (the same step at lr 0) equal in
  value (the signs of some zeros differ); the SGD update (the step at
  ``STEP_LR`` less the step at lr 0) per coordinate within one bf16 ulp
  of the updated weight (both packages round the fp32 update to bf16
  once) plus ``UPDATE_RTOL`` = 2^-5 of the leaf's largest update
  (observed 1.0e-2).  At lr 0.1 the update clears the weights' bf16
  spacing: a dropped update misses by 0.63 or more of that scale, a
  halved one by 0.28;
* the bf16 mask update step: the gradients differ by bf16 rounding, so a
  few coordinates near a threshold flip, held to 1% (observed 0.11%);
  each row's held count within 1% of ``n_active`` of the reference's.
  At bf16 neither package holds a row's count to the budget
  ``n_active``: the threshold rule keeps every tie and bf16 magnitudes
  tie often (observed up to 429 over, the reference's rows up to 372),
  and an embedding row no token of the batch reaches has a zero gradient
  and regrows nothing (14,299 under in both).

The bf16 step tests print what they observe (``pytest -rP``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.masks import apply_mask as ref_apply_mask
from repro.core.masks import init_mask as ref_init_mask
from repro.kernels import ops as ref_ops
from repro.kernels.prune_regrow import prune_regrow_flat as ref_prune_regrow
from repro.launch import steps as ref_steps
from repro.models import bind as ref_bind
from repro.models.common import DTypePolicy as RefPolicy
from repro.scale import stacked as ref_stacked
from repro.serve import MLPModel as RefMLP
from repro.serve import ModelStore as RefStore
from repro.serve import RequestStream as RefStream
from repro.serve import ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.checkpoint.npz import to_numpy, tree_from_numpy
from repro_torch.kernels import masked_matmul as mmk
from repro_torch.kernels import packed_accum as pa
from repro_torch.kernels import prune_regrow as pr
from repro_torch.launch import steps
from repro_torch.models import bind
from repro_torch.models.common import DTypePolicy
from repro_torch.scale import stacked
from repro_torch.serve import MLPModel, ModelStore, RequestStream, ServeEngine
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

pytestmark = pytest.mark.tier1

BF16 = np.dtype(ml_dtypes.bfloat16)
STEP_RTOL = 2.0 ** -8
STEP_LR = 0.1
UPDATE_RTOL = 2.0 ** -5
MASK_FLIP_SHARE = 1e-2
DIMS = dict(d_in=16, widths=(32,), n_out=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same_bits(a, b) -> bool:
    a, b = np.ascontiguousarray(to_numpy(a)), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == \
        b.tobytes()


# ---------------------------------------------------------------------------
# policy and carrier
# ---------------------------------------------------------------------------


def test_dtype_policy_matches_reference():
    for port, ref in ((DTypePolicy(), RefPolicy()),
                      (DTypePolicy.tpu(), RefPolicy.tpu())):
        for field in ("param_dtype", "compute_dtype"):
            assert (to_numpy(torch.zeros((), dtype=getattr(port, field))).dtype
                    == np.dtype(getattr(ref, field)))
    assert DTypePolicy.tpu().param_dtype == torch.bfloat16


def test_bf16_carrier_round_trips_bit_for_bit():
    """Every bf16 pattern class (normal, subnormal, ±0, ±inf, NaN) crosses
    ``tree_from_numpy`` and back through ``to_numpy`` unchanged, and the
    values are the reference's."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 16, 4096, dtype=np.uint16)
    bits[:6] = [0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC1, 0x0001]
    ref = bits.view(BF16).reshape(64, 64)
    tree = tree_from_numpy({"a": {"w": ref}, "f16": np.float16([1.5, -0.0])})
    assert tree["a"]["w"].dtype == torch.bfloat16
    assert tree["f16"].dtype == torch.float16
    assert _same_bits(tree["a"]["w"], ref)
    back = to_numpy(tree["a"]["w"])
    assert back.dtype == BF16 and back.view(np.uint16).tolist() == \
        ref.view(np.uint16).tolist()
    finite = np.isfinite(ref.astype(np.float32))
    np.testing.assert_array_equal(tree["a"]["w"].float().numpy()[finite],
                                  ref.astype(np.float32)[finite])


# ---------------------------------------------------------------------------
# kernels' plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 128, 128), (128, 256, 128),
                                   (70, 200, 90), (13, 50, 17),
                                   (1, 128, 128), (8, 17, 90), (9, 200, 8)])
@pytest.mark.parametrize("density", [0.0, 0.2, 1.0])
def test_bf16_masked_matmul_plain_matches_pallas(shape, density):
    """The reference's bf16 sweep (``tests/test_kernels.py``): bf16 x and
    w, an fp32 mask, its tile sizes and tolerance; beside its shapes the
    ones the CUDA tensor-core kernel tells apart (M = 1, 8 and 9 rows
    about its n8 tile, K = 17 one past a k16 step, N = 8 one mma half)."""
    m, k, n = shape
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(BF16)
    w = rng.standard_normal((k, n)).astype(BF16)
    mask = (rng.random((k, n)) < density).astype(np.float32)
    want = ref_ops.masked_matmul(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(mask), bm=32, bn=64, bk=64)
    counts = (dict(mmk.LAUNCHES_BY_ENTRY), dict(mmk.LAUNCHES_U1_BY_ENTRY))
    got = mmk.masked_matmul(*tree_from_numpy([x, w, mask]))
    assert (mmk.LAUNCHES_BY_ENTRY, mmk.LAUNCHES_U1_BY_ENTRY) == counts
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2 * k ** 0.5, rtol=5e-2)
    # a bf16 mask gives the same product (m is 0 or 1)
    got_b = mmk.masked_matmul(*tree_from_numpy([x, w, mask.astype(BF16)]))
    assert torch.equal(got_b, got)


def test_bf16_batched_masked_matmul_plain_matches_pallas():
    rng = np.random.default_rng(5)
    u, m, k, n = 3, 4, 64, 32
    x = rng.standard_normal((u, m, k)).astype(BF16)
    w = (rng.standard_normal((u, k, n)) / 8).astype(BF16)
    mask = (rng.random((u, k, n)) < 0.5).astype(np.float32)
    want = ref_ops.batched_masked_matmul(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(mask), bm=8, bn=32,
                                         bk=32)
    got = mmk.batched_masked_matmul(*tree_from_numpy([x, w, mask]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2 * k ** 0.5, rtol=5e-2)


def _pr_case(pair, n, seed, ties):
    wdt, mdt = (to_numpy(torch.zeros((), dtype=d)).dtype for d in pair)
    rng = np.random.default_rng(seed)
    m = rng.random(n) < 0.5
    w = rng.standard_normal(n) * m
    g = rng.standard_normal(n)
    if ties:
        w = np.sign(w) * 0.5
        g = np.where(rng.random(n) < 0.5, -0.25, 0.25)
    g[: n // 8] = 0.0
    return w.astype(wdt), g.astype(wdt), m.astype(mdt)


@pytest.mark.parametrize("pair", pr.PAIRS, ids=lambda p: "-".join(
    str(d).replace("torch.", "") for d in p))
@pytest.mark.parametrize("ties", [False, True])
def test_prune_regrow_plain_matches_pallas_every_pair(pair, ties):
    """``prune_regrow_rows_plain`` at K=1 against ``prune_regrow_flat``
    for every (weight, mask) pair, thresholds from ``sort_thresholds`` in
    the native dtype: outputs of m's and w's dtypes, bit for bit."""
    n = 1000
    w, g, m = _pr_case(pair, n, 7, ties)
    tw, tg, tm = (t[None] for t in tree_from_numpy([w, g, m]))
    th = pr.sort_thresholds(tw, tg, tm, n // 4, n // 8)
    assert torch.equal(th, pr.sort_thresholds(tw.float(), tg.float(),
                                              tm.float(), n // 4, n // 8))
    by_entry = dict(pr.LAUNCHES_BY_ENTRY)
    got_m, got_w = pr.prune_regrow_rows(tw, tg, tm, th)
    assert pr.LAUNCHES_BY_ENTRY == by_entry      # the plain version
    want_m, want_w = ref_prune_regrow(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m),
        jnp.float32(th[0, 0].item()), jnp.float32(th[0, 1].item()))
    assert _same_bits(got_m[0], np.asarray(want_m))
    assert _same_bits(got_w[0], np.asarray(want_w))


def test_prune_regrow_refuses_pairs_it_has_no_entry_for():
    w, g, m = (torch.zeros(1, 8) for _ in range(3))
    th = torch.zeros(1, 2)
    for wdt, mdt in ((torch.float16, torch.float16),
                     (torch.bfloat16, torch.float32),
                     (torch.float64, torch.float64)):
        with pytest.raises(TypeError, match="bfloat16, int8"):
            pr.prune_regrow_rows(w.to(wdt), g.to(wdt), m.to(mdt), th)


@pytest.mark.parametrize("wdt", [BF16, np.float32], ids=["bf16", "fp32"])
def test_threshold_update_on_the_same_gradients_equals_reference(wdt):
    """``stacked_prune_regrow_threshold`` on bf16 or fp32 params with int8
    masks, given the same gradients as the reference's: masks and params
    bit for bit, the leaves kept in their own dtypes."""
    rng = np.random.default_rng(11)
    k = 3
    shapes = {"a": (k, 2, 64, 64), "b": (k, 64, 96), "norm": (k, 64)}
    m = {p: (rng.random(s) < 0.4).astype(np.int8) for p, s in shapes.items()}
    w = {p: (rng.integers(-8, 9, size=s) * 0.125 * m[p]).astype(wdt)
         for p, s in shapes.items()}
    g = {p: rng.standard_normal(s).astype(wdt) for p, s in shapes.items()}
    g["b"][1] = 0
    want_m, want_w = ref_stacked.stacked_prune_regrow_threshold(
        *(jax.tree.map(jnp.asarray, t) for t in (w, m, g)), jnp.float32(0.3),
        0.4)
    got_m, got_w = stacked.stacked_prune_regrow_threshold(
        *(tree_from_numpy(t) for t in (w, m, g)), 0.3, 0.4)
    for key in shapes:
        assert _same_bits(got_m[key], np.asarray(want_m[key])), key
        assert _same_bits(got_w[key], np.asarray(want_w[key])), key


# ---------------------------------------------------------------------------
# fp16 stacked payloads and the fp16 store
# ---------------------------------------------------------------------------


def _stacked_world(k=4, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"conv": (k, 3, 3, 8, 16), "fc": {"w": (k, 40, 10),
                                                "b": (k, 10)}}
    w = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32) * 2.0,
                     shapes, is_leaf=lambda s: isinstance(s, tuple))
    w["conv"][0, 0, 0, 0, :4] = [1e-8, -1e-8, 7e4, -7e4]   # under/overflow
    m = jax.tree.map(lambda x: (rng.random(x.shape) < 0.5).astype(np.float32),
                     w)
    m["fc"]["b"][:] = 1.0
    m["conv"][0, 0, 0, 0, :4] = 1.0
    return jax.tree.map(lambda a, b: a * b, w, m), m


def test_pack_stacked_fp16_matches_reference():
    w, m = _stacked_world()
    want = ref_stacked.pack_stacked(w, m, dtype=np.float16)
    got = stacked.pack_stacked(tree_from_numpy(w), tree_from_numpy(m),
                               dtype=torch.float16)
    ref_sp = jax.tree.leaves(want, is_leaf=lambda x: isinstance(
        x, ref_stacked.StackedPacked))
    for sp, rsp in zip(tree_leaves(got, is_leaf=stacked.is_stacked_packed),
                       ref_sp):
        assert sp.values.dtype == torch.float16
        assert _same_bits(sp.values, np.asarray(rsp.values))
        assert _same_bits(sp.bitmap.view(torch.int32),
                          np.asarray(rsp.bitmap).view(np.int32))
        assert sp.nnz.tolist() == np.asarray(rsp.nnz).tolist()
        assert sp.shape == tuple(rsp.shape)


@pytest.mark.parametrize("alpha", [1.0, 0.75])
def test_fp16_row_fold_matches_reference_pallas_rows(alpha):
    """``fold_stacked`` of fp16 payloads into non-zero fp32 accumulators,
    bit-equal to the reference's ``backend="pallas_rows"``."""
    w, m = _stacked_world(seed=1)
    rng = np.random.default_rng(2)
    num = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                       w)
    den = jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32), w)
    want_n, want_d = ref_stacked.fold_stacked(
        jax.tree.map(jnp.asarray, num), jax.tree.map(jnp.asarray, den),
        ref_stacked.pack_stacked(w, m, dtype=np.float16), alpha,
        backend="pallas_rows")
    launches, by_entry = pa.LAUNCHES_ROWS, dict(pa.LAUNCHES_BY_ENTRY)
    got_n, got_d = stacked.fold_stacked(
        tree_from_numpy(num), tree_from_numpy(den),
        stacked.pack_stacked(tree_from_numpy(w), tree_from_numpy(m),
                             dtype=torch.float16), alpha)
    # the CPU runs the plain version: no entry counts a launch
    assert pa.LAUNCHES_ROWS == launches
    assert pa.LAUNCHES_BY_ENTRY == by_entry
    for a, b in zip(tree_leaves(got_n) + tree_leaves(got_d),
                    jax.tree.leaves(want_n) + jax.tree.leaves(want_d)):
        assert _same_bits(a, np.asarray(b))


@pytest.fixture(scope="module")
def mlp_users():
    """The MLP's base and six users' (w ⊙ m, m) from the reference's init
    and ERK masks, as numpy trees."""
    model = RefMLP(rows=2, **DIMS)
    base = _np(model.init(jax.random.PRNGKey(0)))
    keys = jax.random.split(jax.random.PRNGKey(1), 12)
    users = []
    for u in range(6):
        p = model.init(keys[2 * u])
        mask = ref_init_mask(keys[2 * u + 1], p, 0.5)
        users.append((_np(ref_apply_mask(p, mask)), _np(mask)))
    return base, users


def _fp16_stores(mlp_users, cache_size=3):
    base, users = mlp_users
    ref = RefStore(jax.tree.map(jnp.asarray, base), cache_size=cache_size,
                   payload_dtype=np.float16)
    port = ModelStore(tree_from_numpy(base), cache_size=cache_size,
                      payload_dtype=np.float16)
    p, mask = jax.tree.map(np.copy, users[0])
    w, m = jax.tree.leaves(p)[0], jax.tree.leaves(mask)[0]
    w[0, :3], m[0, :3] = [-1e-9, -0.0, 7e4], 1.0    # fp16: -0.0, -0.0, inf
    for u, (p, mask) in enumerate(users + [(p, mask)]):
        assert port.put(u, tree_from_numpy(p), tree_from_numpy(mask)) == \
            ref.put(u, jax.tree.map(jnp.asarray, p),
                    jax.tree.map(jnp.asarray, mask))
    return ref, port


def test_fp16_store_frames_and_models_match_reference(mlp_users):
    """Frames byte-identical (dtype code 1, 2-byte values), sizes and
    nnz equal, and each unpacked model (fp16 values widened into the fp32
    pool) bit-equal to the reference's — the last user holds values that
    round to -0.0 and to inf in fp16."""
    ref, port = _fp16_stores(mlp_users)
    for u in ref.users():
        frame = port.frame(u)
        assert frame == ref._frames[u]
        assert frame[3] == 1                       # the header's dtype code
        assert port.bytes_at_rest(u) == ref.bytes_at_rest(u)
        assert port.nnz(u) == ref.nnz(u)
        for a, b in zip(tree_leaves(port.get(u)),
                        jax.tree.leaves(ref.get(u))):
            assert a.dtype == torch.float32
            assert _same_bits(a, np.asarray(b))
    assert port.stats() == ref.stats()


def test_fp16_store_serves_the_reference_outputs(mlp_users):
    ref, port = _fp16_stores(mlp_users)
    ref_res = RefEngine(ref, RefMLP(rows=2, **DIMS), backend="vmap",
                        max_batch=4).serve(
        RefStream(n_users=6, n_requests=16, seed=4).requests())
    res = ServeEngine(port, MLPModel(rows=2, **DIMS), backend="vmap",
                      max_batch=4).serve(
        RequestStream(n_users=6, n_requests=16, seed=4))
    assert sorted(res.outputs) == sorted(ref_res.outputs)
    for rid, want in ref_res.outputs.items():
        np.testing.assert_allclose(res.outputs[rid], want, atol=1e-5,
                                   rtol=1e-5)
    assert res.summary["store_bytes_at_rest"] == \
        ref_res.summary["store_bytes_at_rest"]


def test_fp16_store_from_checkpoint_matches_reference(tmp_path):
    from repro.checkpoint import save_pytree as ref_save_pytree
    from repro.fl.engine import _pack as ref_pack_lists

    rng = np.random.default_rng(3)
    params, masks = [], []
    for _ in range(3):
        m = {"fc": {"w": (rng.random((16, 8)) < 0.4).astype(np.float32)}}
        params.append({"fc": {"w": rng.standard_normal((16, 8)).astype(
            np.float32) * m["fc"]["w"]}})
        masks.append(m)
    path = str(tmp_path / "engine.npz")
    ref_save_pytree(path, {
        "engine": {"next_round": np.asarray(1, np.int64)},
        "state": ref_pack_lists({"params": params, "masks": masks})})
    ref = RefStore.from_checkpoint(path, cache_size=2,
                                   payload_dtype=np.float16)
    port = ModelStore.from_checkpoint(path, cache_size=2, device="cpu",
                                      payload_dtype=np.float16)
    for u in ref.users():
        assert port.frame(u) == ref._frames[u]
    assert port.stats() == ref.stats()


# ---------------------------------------------------------------------------
# bf16 step builders
# ---------------------------------------------------------------------------


class _FakeMesh:
    shape = {"data": 1, "model": 1}
    axis_names = ("data", "model")


K, B, S = 2, 2, 8


@pytest.fixture(scope="module")
def bf16_steps():
    """qwen3-8b's smoke config cut to two layers, at bf16 with int8 masks,
    K=2 clients: the reference's train step and mask update (``_FakeMesh``
    plan of ``tests/test_scale_steps.py``), from one state and batch."""
    name = "qwen3-8b"
    cfg = dataclasses.replace(ref_configs.SMOKE_ARCHS[name], n_layers=2)
    shape = dataclasses.replace(ref_configs.INPUT_SHAPES["train_4k"],
                                seq_len=S, global_batch=K * B)
    ref_plan = ref_steps.ScalePlan(
        arch=cfg, shape=shape, mesh=_FakeMesh(), n_clients=K,
        per_client_batch=B, fsdp2d=False, seq_data=False, dtype=jnp.bfloat16)
    api = ref_bind(cfg, remat=False)
    keys = jax.random.split(jax.random.PRNGKey(0), K)
    params = jax.jit(jax.vmap(lambda kk: api.init(kk, jnp.bfloat16)))(keys)
    rng = np.random.default_rng(3)
    masks = jax.tree.map(
        lambda x: jnp.asarray((rng.random(x.shape) < 0.5) if x.ndim >= 3
                              else np.ones(x.shape), jnp.int8), params)
    params = jax.tree.map(lambda w, m: w * m.astype(w.dtype), params, masks)
    batch = {"tokens": rng.integers(0, cfg.vocab, (K, B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (K, B, S)).astype(np.int32)}
    adj = np.ones((K, K), np.float32)
    ref_step = jax.jit(ref_steps.make_train_step(api, ref_plan))
    new_p, losses = ref_step(params, masks, batch, jnp.asarray(adj),
                             jnp.float32(STEP_LR))
    gossip_p, _ = ref_step(params, masks, batch, jnp.asarray(adj),
                           jnp.float32(0.0))
    upd_p, upd_m = jax.jit(ref_steps.make_mask_update_step(api, ref_plan,
                                                           0.5))(
        params, masks, batch, jnp.float32(0.25))
    port_cfg = dataclasses.replace(configs.SMOKE_ARCHS[name], n_layers=2)
    plan = steps.ScalePlan(port_cfg, dataclasses.replace(
        configs.INPUT_SHAPES["train_4k"], seq_len=S, global_batch=K * B),
        K, B, torch.bfloat16)
    return {"api_port": bind(port_cfg, remat=False), "plan": plan, "ref_plan": ref_plan, "api": api,
            "params": _np(params), "masks": _np(masks), "batch": batch,
            "adj": adj, "new_params": _np(new_p), "losses": np.asarray(losses),
            "gossip_params": _np(gossip_p),
            "upd_params": _np(upd_p), "upd_masks": _np(upd_m)}


def test_bf16_abstract_state_matches_reference(bf16_steps):
    """``abstract_params``/``abstract_cache`` of a bf16 plan: the
    reference's stacked shapes and dtypes, no storage."""
    api, plan = bf16_steps["api_port"], bf16_steps["plan"]
    got = steps.abstract_params(api, plan)
    want = ref_steps.abstract_params(bf16_steps["api"], bf16_steps["ref_plan"])
    pairs = list(zip(tree_leaves_with_path(got), jax.tree.leaves(want)))
    assert len(pairs) == len(jax.tree.leaves(want))
    for (path, a), b in pairs:
        assert a.device.type == "meta", path
        assert tuple(a.shape) == tuple(b.shape), path
        assert to_numpy(torch.zeros((), dtype=a.dtype)).dtype == b.dtype, path
    got_c = steps.abstract_cache(api, plan)
    want_c = ref_steps.abstract_cache(bf16_steps["api"],
                                      bf16_steps["ref_plan"])
    for a, b in zip(tree_leaves(got_c), jax.tree.leaves(want_c)):
        assert a.device.type == "meta" and tuple(a.shape) == tuple(b.shape)
        assert to_numpy(torch.zeros((), dtype=a.dtype)).dtype == b.dtype


def _bf16_spacing(x: np.ndarray) -> np.ndarray:
    """bf16's spacing at each |x|: ``2^(e - 7)`` for |x| in [2^e, 2^(e+1))."""
    _, e = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def test_bf16_train_step_matches_reference(bf16_steps):
    step = steps.make_train_step(bf16_steps["api_port"], bf16_steps["plan"])
    masks = tree_from_numpy(bf16_steps["masks"])
    args = (masks, tree_from_numpy(bf16_steps["batch"]),
            torch.from_numpy(bf16_steps["adj"]))
    new_p, losses = step(tree_from_numpy(bf16_steps["params"]), *args,
                         STEP_LR)
    gossip_p, _ = step(tree_from_numpy(bf16_steps["params"]), *args, 0.0)
    want = bf16_steps["losses"]
    loss_gap = float(np.max(np.abs(losses.numpy() - want) / np.abs(want)))
    assert loss_gap <= STEP_RTOL
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    update_gap = 0.0
    for (path, a), g, b, gb, m in zip(
            tree_leaves_with_path(new_p), tree_leaves(gossip_p),
            jax.tree.leaves(bf16_steps["new_params"]),
            jax.tree.leaves(bf16_steps["gossip_params"]), tree_leaves(masks)):
        assert a.dtype == torch.bfloat16, path
        assert bool(torch.all(a[m == 0] == 0)), path
        assert np.array_equal(f32(to_numpy(g)), f32(gb)), path
        got, want_u = f32(to_numpy(a)) - f32(gb), f32(b) - f32(gb)
        scale = float(np.abs(want_u).max())
        assert scale > 0, path
        over = np.abs(got - want_u) - _bf16_spacing(f32(b))
        update_gap = max(update_gap, float(over.max()) / scale)
        assert float(over.max()) <= UPDATE_RTOL * scale, path
    print(f"bf16 train step: losses within {loss_gap:.3g} relative; gossip "
          f"equal; update within one bf16 ulp + {update_gap:.3g} of "
          f"its scale")


def test_bf16_mask_update_step_matches_reference(bf16_steps):
    update = steps.make_mask_update_step(bf16_steps["api_port"],
                                         bf16_steps["plan"], 0.5)
    new_p, new_m = update(tree_from_numpy(bf16_steps["params"]),
                          tree_from_numpy(bf16_steps["masks"]),
                          tree_from_numpy(bf16_steps["batch"]), 0.25)
    flips = total = 0
    drift = []                 # each row's held count less n_active
    for w, a, b, wr in zip(tree_leaves(new_p), tree_leaves(new_m),
                           jax.tree.leaves(bf16_steps["upd_masks"]),
                           jax.tree.leaves(bf16_steps["upd_params"])):
        assert a.dtype == torch.int8 and w.dtype == torch.bfloat16
        assert bool(torch.all(w[a == 0] == 0))
        if not stacked.default_threshold_sparsifiable(w):
            assert _same_bits(a, b) and _same_bits(w, wr)
            continue
        a = a.numpy()
        flips += int((a != b).sum())
        total += a.size
        n_active = round(0.5 * a[0].size)
        got_c = (a != 0).reshape(K, -1).sum(1)
        want_c = (b != 0).reshape(K, -1).sum(1)
        assert np.all(np.abs(got_c - want_c) <= 0.01 * n_active)
        drift += [(int(x - n_active), int(y - n_active))
                  for x, y in zip(got_c, want_c)]
    assert flips <= MASK_FLIP_SHARE * total
    print(f"bf16 mask update: {flips} of {total} sparsifiable coordinates "
          f"({flips / total:.3%}) differ from the reference's; a row's held "
          f"count less n_active, port / reference: "
          f"{max(d[0] for d in drift)} / {max(d[1] for d in drift)} at most, "
          f"{min(d[0] for d in drift)} / {min(d[1] for d in drift)} at least")
