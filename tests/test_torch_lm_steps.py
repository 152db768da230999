"""The port's LM step builders (``repro_torch.launch.steps``), stacked gossip
(``repro_torch.core.gossip``) and LM corpus against the JAX reference
(``repro.launch.steps``) on the CPU.  The ``lm`` loop and its CLI are
``test_torch_lm_loop.py``'s.

States start from the reference's: its stacked params and int8 masks (the
setup of ``tests/test_scale_steps.py``) or, for the ``lm`` loop, the
initial params and masks its ``run_lm`` draws from ``PRNGKey(seed)``,
carried across as numpy arrays.  Values are held to ``1e-5 *
max(1, max|ref|)``; masks, tokens and corpora exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.gossip import gossip_average_stacked as ref_gossip
from repro.core.gossip import plain_gossip_stacked as ref_plain_gossip
from repro.data import make_lm_corpus as ref_make_lm_corpus
from repro.launch import steps as ref_steps
from repro.models import bind as ref_bind
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro.utils.tree import tree_stack as ref_tree_stack
from repro_torch import configs
from repro_torch.checkpoint.npz import tree_from_numpy
from repro_torch.core.gossip import gossip_average_stacked
from repro_torch.core.gossip import plain_gossip_stacked
from repro_torch.data.synthetic import make_lm_corpus
from repro_torch.launch import steps
from repro_torch.launch import train
from repro_torch.models import bind
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

pytestmark = pytest.mark.tier1

TOL = 1e-5
K, B, S = 3, 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager forwards and backwards of tiny models: under the suite's
    parallel workers torch's intra-op threads only contend for the cores,
    so the module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_close(got, want, what=""):
    """``max|got - want| <= TOL * max(1, max|want|)``, shapes equal."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: max abs err {err} > {TOL} x {scale}"


def _assert_close_trees(ref_tree, port_tree, what):
    ra, pa = ref_leaves(ref_tree), tree_leaves_with_path(port_tree)
    assert [p for p, _ in ra] == [p for p, _ in pa], what
    for (path, x), (_, y) in zip(ra, pa):
        assert_close(y, x, f"{what} {path}")


class _FakeMesh:
    shape = {"data": 1, "model": 1}
    axis_names = ("data", "model")


def _plans(name, k=K, b=B, s=S, mode="train"):
    """The reference's plan (with the stand-in mesh its own step tests use)
    and the port's, for one smoke arch."""
    key = {"train": "train_4k", "prefill": "prefill_32k",
           "decode": "decode_32k"}[mode]
    ref_shape = dataclasses.replace(ref_configs.INPUT_SHAPES[key],
                                    seq_len=s, global_batch=k * b)
    shape = dataclasses.replace(configs.INPUT_SHAPES[key], seq_len=s,
                                global_batch=k * b)
    ref_plan = ref_steps.ScalePlan(
        arch=ref_configs.SMOKE_ARCHS[name], shape=ref_shape, mesh=_FakeMesh(),
        n_clients=k, per_client_batch=b, fsdp2d=False, seq_data=False,
        dtype=jnp.float32)
    plan = steps.ScalePlan(arch=configs.SMOKE_ARCHS[name], shape=shape,
                           n_clients=k, per_client_batch=b)
    return ref_plan, plan


def _stacked_state(api, k):
    """``tests/test_scale_steps.py``'s state: K clients' params, int8 masks
    at density ~0.5 on the matrix leaves, params masked."""
    keys = jax.random.split(jax.random.PRNGKey(0), k)
    params = ref_tree_stack([api.init(kk) for kk in keys])
    masks = jax.tree.map(
        lambda x: (jax.random.uniform(jax.random.PRNGKey(1), x.shape) < 0.5)
        .astype(jnp.int8) if x.ndim >= 3 else jnp.ones(x.shape, jnp.int8),
        params)
    params = jax.tree.map(lambda w, m: w * m.astype(w.dtype), params, masks)
    return _np(params), _np(masks)


def _batch(vocab, k=K, b=B, s=S, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (k, b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (k, b, s)).astype(np.int32)}


@pytest.fixture(scope="module")
def qwen():
    name = "qwen3-8b"
    api = ref_bind(ref_configs.SMOKE_ARCHS[name], remat=False)
    params, masks = _stacked_state(api, K)
    return {"name": name, "api": api, "params": params, "masks": masks,
            "batch": _batch(ref_configs.SMOKE_ARCHS[name].vocab)}


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gossip", ["einsum", "einsum_bf16", "einsum_noopt",
                                    "none"])
def test_train_step_matches_reference(qwen, gossip):
    ref_plan, plan = _plans(qwen["name"])
    adj = np.ones((K, K), np.float32)
    adj[0, 2] = adj[2, 1] = 0.0                  # an irregular topology
    lr = 0.01
    want_params, want_losses = jax.jit(
        ref_steps.make_train_step(qwen["api"], ref_plan, gossip))(
        qwen["params"], qwen["masks"], jax.tree.map(jnp.asarray,
                                                    qwen["batch"]),
        jnp.asarray(adj), jnp.float32(lr))
    step = steps.make_train_step(
        bind(configs.SMOKE_ARCHS[qwen["name"]], remat=False), plan, gossip)
    masks = tree_from_numpy(qwen["masks"])
    got_params, got_losses = step(tree_from_numpy(qwen["params"]), masks,
                                  tree_from_numpy(qwen["batch"]),
                                  torch.from_numpy(adj), lr)
    assert_close(got_losses, want_losses, "losses")
    _assert_close_trees(_np(want_params), got_params, f"{gossip} params")
    # dormant coordinates stay exactly zero after gossip + update
    for (path, w), (_, m) in zip(tree_leaves_with_path(got_params),
                                 tree_leaves_with_path(masks)):
        assert w.dtype == torch.float32, path
        assert bool(torch.all(w[m == 0] == 0)), path


def test_train_step_skips_the_identity_mix_at_one_client(qwen):
    """K=1: 'einsum' skips the 1x1 identity mix, 'einsum_noopt' runs it;
    both give the reference's step (w is already masked)."""
    ref_plan, plan = _plans(qwen["name"], k=1)
    one = lambda t: t[:1]  # noqa: E731
    params, masks = jax.tree.map(one, qwen["params"]), jax.tree.map(
        one, qwen["masks"])
    batch = jax.tree.map(one, qwen["batch"])
    adj = np.ones((1, 1), np.float32)
    want, _ = jax.jit(ref_steps.make_train_step(qwen["api"], ref_plan))(
        params, masks, jax.tree.map(jnp.asarray, batch), jnp.asarray(adj),
        jnp.float32(0.01))
    api = bind(configs.SMOKE_ARCHS[qwen["name"]], remat=False)
    for gossip in ("einsum", "einsum_noopt"):
        got, _ = steps.make_train_step(api, plan, gossip)(
            tree_from_numpy(params), tree_from_numpy(masks),
            tree_from_numpy(batch), adj, 0.01)
        _assert_close_trees(_np(want), got, gossip)


def test_train_step_refuses_ppermute_and_unknown_modes(qwen):
    """Unknown gossip modes are refused; ``"ppermute"``, the reference's
    ring gossip, is built (its values: ``tests/test_torch_gossip_opt.py``)."""
    _, plan = _plans(qwen["name"])
    api = bind(configs.SMOKE_ARCHS[qwen["name"]])
    assert callable(steps.make_train_step(api, plan, "ppermute"))
    with pytest.raises(ValueError, match="gossip must be one of"):
        steps.make_train_step(api, plan, "allreduce")


# ---------------------------------------------------------------------------
# mask update, prefill, decode
# ---------------------------------------------------------------------------


def test_mask_update_step_matches_reference(qwen):
    ref_plan, plan = _plans(qwen["name"], k=2)
    two = lambda t: t[:2]  # noqa: E731
    params = jax.tree.map(two, qwen["params"])
    masks = jax.tree.map(two, qwen["masks"])
    batch = jax.tree.map(two, qwen["batch"])
    rate = 0.3
    want_params, want_masks = jax.jit(
        ref_steps.make_mask_update_step(qwen["api"], ref_plan, density=0.5))(
        params, masks, jax.tree.map(jnp.asarray, batch), jnp.float32(rate))
    got_params, got_masks = steps.make_mask_update_step(
        bind(configs.SMOKE_ARCHS[qwen["name"]], remat=False), plan,
        density=0.5)(
        tree_from_numpy(params), tree_from_numpy(masks),
        tree_from_numpy(batch), rate)
    n_sparse = 0
    for (path, m0), (_, want), (_, got), (_, w1) in zip(
            ref_leaves(masks), ref_leaves(_np(want_masks)),
            tree_leaves_with_path(got_masks),
            tree_leaves_with_path(got_params)):
        assert got.dtype == torch.int8, path
        got = got.numpy()
        # equal up to threshold ties: a gradient or weight on a kth order
        # statistic that rounds differently may flip a coordinate
        assert (got != want).mean() <= 1e-3, path
        if m0.ndim >= 3 and m0.shape[-1] >= 64 and m0.shape[-2] >= 64:
            n_sparse += 1
            n = m0.reshape(2, -1).shape[1]
            after = got.reshape(2, -1).sum(1)
            # the reference test's budget bounds
            assert np.all(after <= 0.5 * n + max(8, 0.02 * n)), path
            assert np.all(after >= 0.5 * n * (1 - rate) - max(8, 0.02 * n))
        assert bool(torch.all(w1[torch.from_numpy(got) == 0] == 0)), path
    assert n_sparse > 0
    # the surviving weights are the inputs' (pruned ones +0, grown ones 0)
    for (path, x), (_, y) in zip(ref_leaves(_np(want_params)),
                                 tree_leaves_with_path(got_params)):
        agree = (y.numpy() != 0) == (x != 0)
        assert agree.mean() >= 1 - 1e-3, path
        assert_close(y.numpy()[agree], x[agree], f"params {path}")


@pytest.mark.parametrize("name", ["mamba2-1.3b", "gemma3-1b"])
def test_prefill_and_decode_steps_match_reference(name):
    """``make_prefill_step`` then three ``make_decode_step`` steps per
    client (each client at its own position): tokens equal, logits and
    caches within tolerance."""
    k, b, s0, n_steps = 2, 2, 6, 3
    ref_plan, plan = _plans(name, k=k, b=b, s=s0 + n_steps, mode="decode")
    api = ref_bind(ref_configs.SMOKE_ARCHS[name], remat=False)
    params, _ = _stacked_state(api, k)
    prompt = {"tokens": np.random.default_rng(5).integers(
        0, api.cfg.vocab, (k, b, s0)).astype(np.int32)}
    max_len = s0 + n_steps
    cache = jax.vmap(lambda _: api.init_cache(b, max_len))(jnp.arange(k))
    logits, cache = jax.jit(ref_steps.make_prefill_step(api, ref_plan))(
        params, jax.tree.map(jnp.asarray, prompt), cache)
    want = [(np.asarray(logits), _np(cache))]
    tok = jnp.argmax(logits[:, :, -1], -1)[..., None].astype(jnp.int32)
    toks = [np.asarray(tok)]
    decode = jax.jit(ref_steps.make_decode_step(api, ref_plan))
    for i in range(n_steps):
        pos = jnp.asarray([s0 + i, s0 + i], jnp.int32)
        nxt, cache = decode(params, {"tokens": tok, "pos": pos}, cache)
        tok = nxt[..., None]
        toks.append(np.asarray(tok))
        want.append((None, _np(cache)))

    papi = bind(configs.SMOKE_ARCHS[name], remat=False)
    tparams = tree_from_numpy(params)
    pcache = tree_map(lambda t: torch.stack([t] * k),
                      papi.init_cache(b, max_len))
    got_logits, pcache = steps.make_prefill_step(papi, plan)(
        tparams, tree_from_numpy(prompt), pcache)
    assert_close(got_logits, want[0][0], "prefill logits")
    _assert_close_trees(want[0][1], pcache, "prefill cache")
    ptok = torch.argmax(got_logits[:, :, -1], -1)[..., None].to(torch.int32)
    assert np.array_equal(ptok.numpy(), toks[0])
    dstep = steps.make_decode_step(papi, plan)
    for i in range(n_steps):
        pos = torch.tensor([s0 + i, s0 + i], dtype=torch.int32)
        nxt, pcache = dstep(tparams, {"tokens": ptok, "pos": pos}, pcache)
        assert nxt.dtype == torch.int32 and nxt.shape == (k, b)
        ptok = nxt[..., None]
        assert np.array_equal(ptok.numpy(), toks[i + 1]), f"step {i}"
        _assert_close_trees(want[i + 1][1], pcache, f"step {i} cache")


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_stacked_input_specs_match_reference(mode):
    for name in ("gemma3-1b", "llava-next-mistral-7b",
                 "seamless-m4t-large-v2"):
        ref_plan, plan = _plans(name, s=64, mode=mode)
        got = steps.input_specs(bind(configs.SMOKE_ARCHS[name]), plan)
        want = ref_steps.input_specs(
            ref_bind(ref_configs.SMOKE_ARCHS[name]), ref_plan)
        pairs = lambda leaves: {  # noqa: E731
            p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in leaves}
        assert (pairs(tree_leaves_with_path(got))
                == pairs(ref_leaves(want))), (name, mode)
    masks = steps.abstract_masks(steps._stack_specs(
        {"w": torch.empty((3, 4), device="meta")}, 2))
    assert masks["w"].shape == (2, 3, 4) and masks["w"].dtype == torch.int8


# ---------------------------------------------------------------------------
# stacked gossip, corpus
# ---------------------------------------------------------------------------


def test_stacked_gossip_matches_reference(qwen):
    adj = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]], np.float32)
    want = ref_gossip(qwen["params"], qwen["masks"], jnp.asarray(adj))
    got = gossip_average_stacked(tree_from_numpy(qwen["params"]),
                                 tree_from_numpy(qwen["masks"]), adj)
    _assert_close_trees(_np(want), got, "gossip_average_stacked")
    mix = np.array([[.5, .25, .25], [.25, .5, .25], [0, .5, .5]], np.float32)
    want = ref_plain_gossip(qwen["params"], jnp.asarray(mix))
    got = plain_gossip_stacked(tree_from_numpy(qwen["params"]), mix)
    _assert_close_trees(_np(want), got, "plain_gossip_stacked")


def test_make_lm_corpus_is_bit_equal():
    want = ref_make_lm_corpus(4, vocab=64, n_domains=3,
                              tokens_per_domain=500)
    got = make_lm_corpus(4, vocab=64, n_domains=3, tokens_per_domain=500)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# the lm loop and its CLI
# ---------------------------------------------------------------------------


LOOP_ARGV = ["lm", "--clients", "2", "--rounds", "3", "--steps", "6",
             "--seq", "32", "--batch-size", "2", "--tokens-per-client",
             "2048"]
# gemma3's smoke loop is chaotic: its tied N(0, 1) embedding gives losses
# of 30-110 and gradients that amplify fp32 rounding ~3x a step, so the
# round-2 evolve flips a few near-tied coordinates and round 3 departs
# (observed 1.1e-4 relative; the port alone moves 1.9e-2 when its initial
# params are scaled by 1 + 1e-7).  ROADMAP Queue C records it: the rounds
# before a mask can flip are held to TOL, the rest to CHAOTIC_TOL.
CHAOTIC_ROUNDS = {"gemma3-1b": 2}
CHAOTIC_TOL = 1e-3


