"""The port's ring gossip (``repro_torch.launch.gossip_opt.ppermute_gossip``)
and ``make_train_step(..., "ppermute")`` against the reference's
(``repro.launch.gossip_opt``, ``repro.launch.steps``) on the CPU.

``ppermute_gossip`` is elementwise (rolls, products, sums, one divide), so
the port is held to the reference's bits, fp32 and bf16 alike.  The train
step adds the vmapped loss and its gradient (matmuls, summed in another
order by XLA and by torch), so it is held to the train-step tolerance of
``tests/test_torch_lm_steps.py``: ``1e-5 * max(1, max|ref|)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.launch.gossip_opt import ppermute_gossip as ref_ppermute
from repro.models import bind as ref_bind
from repro.utils.tree import tree_stack as ref_tree_stack
from repro_torch import configs
from repro_torch.checkpoint.npz import tree_from_numpy
from repro_torch.launch import steps
from repro_torch.launch.gossip_opt import ppermute_gossip
from repro_torch.models import bind
from repro_torch.utils.tree import tree_leaves_with_path
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1

TOL = 1e-5
SHAPES = {"w": (5, 7), "b": (9,), "c": (3, 4, 2)}   # per-client leaf shapes


def _ring_state(k, seed):
    rng = np.random.default_rng(seed)
    masks = {n: (rng.random((k,) + s) < 0.5).astype(np.int8)
             for n, s in SHAPES.items()}
    params = {n: (rng.normal(size=(k,) + s) * masks[n]).astype(np.float32)
              for n, s in SHAPES.items()}
    return params, masks


def _bits(x):
    x = np.asarray(x)
    return x.view({4: np.int32, 2: np.int16}[x.dtype.itemsize])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("degree", [2, 4])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_ppermute_gossip_bit_equal_to_reference(k, degree, dtype):
    params, masks = _ring_state(k, 10 * k + degree)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    ref_params = {n: jnp.asarray(w.astype(np_dt)) for n, w in params.items()}
    want = jax.jit(lambda p, m: ref_ppermute(p, m, degree=degree))(
        ref_params, {n: jnp.asarray(m) for n, m in masks.items()})
    got = ppermute_gossip(
        tree_from_numpy({n: np.asarray(w) for n, w in ref_params.items()}),
        tree_from_numpy(masks), degree=degree)
    for n in SHAPES:
        g = got[n]
        assert g.dtype == getattr(torch, dtype), n
        g_np = (g.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                if dtype == "bfloat16" else g.numpy())
        np.testing.assert_array_equal(_bits(g_np), _bits(want[n]),
                                      err_msg=f"{n} K={k} degree={degree}")


def test_ppermute_train_step_matches_reference():
    """The qwen3-8b smoke arch at K=3 (``test_scale_steps.py``'s state)."""
    name, k, b, s = "qwen3-8b", 3, 2, 16
    api = ref_bind(ref_configs.SMOKE_ARCHS[name], remat=False)
    keys = jax.random.split(jax.random.PRNGKey(0), k)
    params = ref_tree_stack([api.init(kk) for kk in keys])
    masks = jax.tree.map(
        lambda x: (jax.random.uniform(jax.random.PRNGKey(1), x.shape) < 0.5)
        .astype(jnp.int8) if x.ndim >= 3 else jnp.ones(x.shape, jnp.int8),
        params)
    params = jax.tree.map(lambda w, m: w * m.astype(w.dtype), params, masks)
    params, masks = (jax.tree.map(np.asarray, t) for t in (params, masks))
    rng = np.random.default_rng(3)
    vocab = ref_configs.SMOKE_ARCHS[name].vocab
    batch = {key: rng.integers(0, vocab, (k, b, s)).astype(np.int32)
             for key in ("tokens", "labels")}

    ref_shape = dataclasses.replace(ref_configs.INPUT_SHAPES["train_4k"],
                                    seq_len=s, global_batch=k * b)
    ref_plan = ref_steps.ScalePlan(
        arch=ref_configs.SMOKE_ARCHS[name], shape=ref_shape, mesh=None,
        n_clients=k, per_client_batch=b, fsdp2d=False, seq_data=False,
        dtype=jnp.float32)
    adj = np.ones((k, k), np.float32)
    want_params, want_losses = jax.jit(
        ref_steps.make_train_step(api, ref_plan, "ppermute"))(
        params, masks, jax.tree.map(jnp.asarray, batch), jnp.asarray(adj),
        jnp.float32(0.01))

    shape = dataclasses.replace(configs.INPUT_SHAPES["train_4k"], seq_len=s,
                                global_batch=k * b)
    plan = steps.ScalePlan(configs.SMOKE_ARCHS[name], shape, k, b)
    step = steps.make_train_step(
        bind(configs.SMOKE_ARCHS[name], remat=False), plan, "ppermute")
    got_params, got_losses = step(
        tree_from_numpy(params), tree_from_numpy(masks),
        tree_from_numpy(batch), torch.from_numpy(adj),
        torch.tensor(0.01, dtype=torch.float32))

    def close(got, want, what):
        want = np.asarray(want, np.float32)
        scale = max(1.0, float(np.abs(want).max(initial=0.0)))
        err = float(np.abs(got.detach().float().numpy() - want).max(
            initial=0.0))
        assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"

    close(got_losses, want_losses, "losses")
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, want_params)))
    got = tree_leaves_with_path(got_params)
    assert {p for p, _ in got} == set(want)
    for path, w in got:
        close(w, want[path], path)
