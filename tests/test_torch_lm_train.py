"""The training half of the port's LM families (``repro_torch.models``:
``train_loss``, ``forward_train``, ``_local_attention``, ``decode``,
``input_specs``; the MoE combine) against the JAX reference on the CPU.

Every comparison starts from the reference's params carried across as
numpy arrays (``checkpoint.npz.tree_from_numpy``) and holds
``max|port - ref| <= 1e-5 * max(1, max|ref|)`` (the rule of
``tests/test_torch_lm.py``: the tied-embedding logits have a standard
deviation of 16, so an absolute 1e-5 cannot hold).  The reference's jitted
functions are built once per arch for the module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import bind as ref_bind
from repro.models import moe as ref_moe
from repro.models.common import accuracy as ref_accuracy
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch import configs
from repro_torch.checkpoint.npz import tree_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import bind
from repro_torch.models import encdec
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.models.common import accuracy
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

pytestmark = pytest.mark.tier1

TOL = 1e-5
ARCHS = sorted(configs.SMOKE_ARCHS)
ROWS = 2
SEQ = 32            # two windows of the smoke gemma3's 16: the banded path
ENC_LEN = 8
PROMPT, DECODE_STEPS = 4, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager forwards and backwards of tiny models, hundreds of small ops
    each: under the suite's parallel workers torch's intra-op threads only
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
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: max abs err {err} > {TOL} x {scale}"


def _assert_close_trees(ref_tree, port_tree, what):
    ra, pa = ref_leaves(ref_tree), tree_leaves_with_path(port_tree)
    assert [p for p, _ in ra] == [p for p, _ in pa], what
    for (path, x), (_, y) in zip(ra, pa):
        assert_close(y, x, f"{what} {path}")


def _train_batch(cfg, seed=0):
    """ROWS x SEQ tokens and labels; a VLM's prefix occupies the first
    positions (labels -1 there), the audio model takes frames."""
    rng = np.random.default_rng(seed)
    n_text = SEQ - cfg.prefix_len
    batch = {"tokens": rng.integers(0, cfg.vocab, (ROWS, n_text)),
             "labels": rng.integers(0, cfg.vocab, (ROWS, SEQ))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if cfg.prefix_len:
        batch["prefix"] = rng.standard_normal(
            (ROWS, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        batch["labels"][:, :cfg.prefix_len] = -1
    if cfg.enc_layers:
        batch["frames"] = rng.standard_normal(
            (ROWS, ENC_LEN, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """One smoke arch: the reference's params, its train loss, aux and
    gradients on one batch, and its prefill followed by DECODE_STEPS greedy
    decode steps (logits and caches of each), built once."""
    name = request.param
    cfg = ref_configs.SMOKE_ARCHS[name]
    api = ref_bind(cfg, remat=False)
    params = api.init(jax.random.PRNGKey(0))
    batch = _train_batch(cfg)
    (loss, metrics), grads = jax.jit(
        jax.value_and_grad(api.train_loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))

    prompt = {"tokens": batch["tokens"][:, :PROMPT]}
    kw = {}
    if cfg.prefix_len:
        prompt["prefix"] = batch["prefix"]
    if cfg.enc_layers:
        prompt["frames"] = batch["frames"]
        kw["enc_len"] = ENC_LEN
    max_len = PROMPT + cfg.prefix_len + DECODE_STEPS
    cache = api.init_cache(ROWS, max_len, **kw)
    logits, cache = jax.jit(api.prefill)(
        params, jax.tree.map(jnp.asarray, prompt), cache)
    steps = [(np.asarray(logits), _np(cache))]
    decode = jax.jit(api.decode)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    for i in range(DECODE_STEPS):
        pos = PROMPT + cfg.prefix_len + i
        logits, cache = decode(params, tok, jnp.int32(pos), cache)
        steps.append((np.asarray(logits), _np(cache)))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    return {"name": name, "params": _np(params), "batch": batch,
            "loss": float(loss), "xent": float(metrics["xent"]),
            "aux": float(metrics["aux"]), "grads": _np(grads),
            "prompt": prompt, "kw": kw, "max_len": max_len, "steps": steps}


# ---------------------------------------------------------------------------
# training loss and gradients
# ---------------------------------------------------------------------------


def test_train_loss_and_grads_match_reference(arch):
    api = bind(configs.SMOKE_ARCHS[arch["name"]], remat=False)
    grads, (loss, metrics) = torch.func.grad_and_value(
        api.train_loss, has_aux=True)(tree_from_numpy(arch["params"]),
                                      tree_from_numpy(arch["batch"]))
    assert_close(loss, np.float32(arch["loss"]), "loss")
    assert_close(metrics["xent"], np.float32(arch["xent"]), "xent")
    assert_close(metrics["aux"], np.float32(arch["aux"]), "aux")
    _assert_close_trees(arch["grads"], grads, "grads")


def test_moe_archs_carry_an_aux_loss(arch):
    """The router's load-balance loss reaches train_loss (summed over the
    prelude, the blocks and the tail) exactly for the MoE families."""
    has_moe = configs.SMOKE_ARCHS[arch["name"]].moe is not None
    assert (arch["aux"] > 0) == has_moe


# ---------------------------------------------------------------------------
# banded local attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hkv", [1, 2])
def test_local_attention_matches_reference_and_masked_path(hkv):
    cfg = configs.SMOKE_ARCHS["gemma3-1b"]
    rng = np.random.default_rng(hkv)
    b, s, h, dh, window = 2, 64, 4, 16, 16
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    want = ref_attn._local_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), cfg, window)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attn._local_attention(tq, tk, tv, cfg, window)
    assert_close(got, want, "local attention")
    masked = attn._sdpa(tq, tk, tv, cfg, attn.causal_mask(s, s, 0, window))
    assert_close(got, masked.numpy(), "banded vs masked")


def test_forward_train_takes_the_banded_path_when_the_window_tiles():
    """gemma3's local layers at SEQ = 2 windows run ``_local_attention``;
    at a length the window does not tile, the masked path."""
    cfg = configs.SMOKE_ARCHS["gemma3-1b"]
    calls = []
    orig = attn._local_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return orig(*a, **kw)

    params = bind(cfg).init(torch.Generator().manual_seed(0))
    attn._local_attention = spy
    try:
        with torch.no_grad():
            lm.forward_train(params, torch.zeros((1, SEQ), dtype=torch.int64),
                             cfg)
            n_banded = len(calls)
            lm.forward_train(params, torch.zeros((1, SEQ - 8),
                                                 dtype=torch.int64), cfg)
    finally:
        attn._local_attention = orig
    n_local = sum(1 for sub in configs.layer_kinds(cfg) if sub.window > 0)
    assert n_local > 0 and n_banded == n_local == len(calls)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def test_prefill_then_decode_match_reference(arch):
    """Prefill PROMPT tokens, then DECODE_STEPS greedy one-token decodes:
    every step's logits and whole cache against the reference's."""
    cfg = configs.SMOKE_ARCHS[arch["name"]]
    api = bind(cfg)
    params = tree_from_numpy(arch["params"])
    cache = api.init_cache(ROWS, arch["max_len"], **arch["kw"])
    logits, cache = api.prefill(params, tree_from_numpy(arch["prompt"]),
                                cache)
    for i, (want_logits, want_cache) in enumerate(arch["steps"]):
        if i:
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            pos = torch.tensor(PROMPT + cfg.prefix_len + i - 1,
                               dtype=torch.int32)
            logits, cache = api.decode(params, tok, pos, cache)
        assert_close(logits, want_logits, f"step {i} logits")
        _assert_close_trees(want_cache, cache, f"step {i} cache")


@pytest.mark.parametrize("name", ["gemma3-1b", "qwen3-8b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b", "deepseek-moe-16b",
                                  "seamless-m4t-large-v2"])
def test_decode_matches_teacher_forcing(name):
    """Prefill + decode logits equal the full training forward at the same
    positions (KV caches, window masks, SSM recurrent states; the exact MoE
    oracle, since the capacity dispatch drops by batch size)."""
    cfg = configs.SMOKE_ARCHS[name]
    api = bind(cfg, moe_dense=True)
    gen = torch.Generator().manual_seed(0)
    params = api.init(gen)
    b, s0, steps = 2, 12, 4
    toks = torch.randint(0, cfg.vocab, (b, s0 + steps), generator=gen)
    kw, batch = {}, {"tokens": toks[:, :s0]}
    with torch.no_grad():
        if cfg.enc_layers:
            frames = torch.randn((b, ENC_LEN, cfg.d_model), generator=gen)
            full, _ = encdec.decode_train(params, frames, toks, cfg)
            batch["frames"], kw["enc_len"] = frames, ENC_LEN
        else:
            full, _ = lm.forward_train(params, toks, cfg, moe_dense=True)
        cache = api.init_cache(b, s0 + steps, **kw)
        logits, cache = api.prefill(params, batch, cache)
        assert_close(logits[:, 0], full[:, s0 - 1].numpy(), "prefill")
        for i in range(steps):
            logits, cache = api.decode(params, toks[:, s0 + i][:, None],
                                       torch.tensor(s0 + i), cache)
            assert_close(logits[:, 0], full[:, s0 + i].numpy(),
                         f"{name} decode step {i}")


def test_decode_under_vmap_writes_each_clients_position():
    """The decode's cache write is a ``torch.where`` over positions, so it
    runs under ``torch.func.vmap`` with a different ``pos`` per client: each
    client's K/V land at its own position, every other slot keeps its bits,
    and the logits equal the client decoded alone (to the rounding of a
    batched against a single matmul)."""
    cfg = configs.SMOKE_ARCHS["gemma3-1b"]
    api = bind(cfg)
    gen = torch.Generator().manual_seed(1)
    params = api.init(gen)
    # random contents: slots a decode must not touch
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen),
                     api.init_cache(1, 8))
    toks = torch.tensor([[[3]], [[5]]])
    pos = torch.tensor([2, 6])
    stacked = lambda t: torch.stack([t, t])  # noqa: E731
    logits, new = torch.func.vmap(api.decode, in_dims=(None, 0, 0, 0))(
        params, toks, pos, tree_map(stacked, cache))
    for c in range(2):
        want, want_cache = api.decode(params, toks[c], pos[c], cache)
        assert_close(logits[c], want.numpy(), f"client {c} logits")
        got_cache = tree_map(lambda t: t[c], new)
        _assert_close_trees(tree_map(lambda t: t.numpy(), want_cache),
                            got_cache, f"client {c} cache")
        for path, x in tree_leaves_with_path(got_cache):
            if path.endswith(("/k", "/v")):         # (n_blocks, B, S, H, D)
                keep = torch.arange(8) != pos[c]
                old = dict(tree_leaves_with_path(cache))[path]
                assert torch.equal(x[:, :, keep], old[:, :, keep]), path
                assert not torch.equal(x[:, :, pos[c]], old[:, :, pos[c]])


# ---------------------------------------------------------------------------
# input specs, accuracy
# ---------------------------------------------------------------------------


def _as_pairs(tree, leaves):
    return {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in leaves(tree)}


@pytest.mark.parametrize("mode", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_reference(mode):
    for name in ARCHS:
        for dtype, ref_dtype in ((torch.float32, jnp.float32),
                                 (torch.bfloat16, jnp.bfloat16)):
            shape = dataclasses.replace(configs.INPUT_SHAPES[mode],
                                        seq_len=64)
            ref_shape = dataclasses.replace(ref_configs.INPUT_SHAPES[mode],
                                            seq_len=64)
            got = bind(configs.SMOKE_ARCHS[name]).input_specs(
                shape, dtype, batch=3)
            want = ref_bind(ref_configs.SMOKE_ARCHS[name]).input_specs(
                ref_shape, ref_dtype, batch=3)
            assert all(x.device.type == "meta" for _, x in
                       tree_leaves_with_path(got)), name
            assert (_as_pairs(got, tree_leaves_with_path)
                    == _as_pairs(want, ref_leaves)), (name, mode)


def test_accuracy_matches_reference():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (3, 5)).astype(np.int32)
    got = accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = ref_accuracy(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


# ---------------------------------------------------------------------------
# MoE: top-k > 2, the combine order, gradients through the gathers
# ---------------------------------------------------------------------------


def _moe_top3():
    spec = configs.MoESpec(n_experts=4, top_k=3, d_expert=32, n_shared=1)
    ref_spec = ref_configs.MoESpec(n_experts=4, top_k=3, d_expert=32,
                                   n_shared=1)
    d = 48
    params = _np(ref_moe.moe_init(jax.random.PRNGKey(3), d, ref_spec,
                                  jnp.float32))
    x = np.random.default_rng(8).standard_normal((2, 12, d)).astype(
        np.float32)
    return spec, ref_spec, params, x


def test_moe_top3_value_and_grads_match_reference():
    spec, ref_spec, params, x = _moe_top3()

    def ref_fn(p, xx):
        y, aux = ref_moe.moe_apply(p, xx, ref_spec)
        return jnp.sum(y * jnp.cos(xx)) + aux

    def port_fn(p, xx):
        y, aux = moe.moe_apply(p, xx, spec)
        return torch.sum(y * torch.cos(xx)) + aux

    want, (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        ref_fn, argnums=(0, 1)))(params, jnp.asarray(x))
    (gp, gx), got = torch.func.grad_and_value(port_fn, argnums=(0, 1))(
        tree_from_numpy(params), torch.from_numpy(x))
    assert_close(got, np.float32(want), "moe top-3 value")
    assert_close(gx, want_gx, "moe top-3 dx")
    _assert_close_trees(_np(want_gp), gp, "moe top-3 dparams")
    y, _ = moe.moe_apply(tree_from_numpy(params), torch.from_numpy(x), spec)
    ref_y, _ = jax.jit(ref_moe.moe_apply, static_argnums=2)(
        params, jnp.asarray(x), ref_spec)
    assert_close(y, ref_y, "moe top-3 output")


def test_moe_combine_adds_in_expert_id_order():
    """``_combine`` is bit-equal to adding each token's terms one by one to
    a zero row in ascending expert id — the order of the reference's
    ``y.at[tt_s].add`` over expert-sorted entries — and not, in general, to
    the top-k order."""
    rng = np.random.default_rng(9)
    n, k, e, d = 64, 3, 6, 16
    eids = np.stack([rng.permutation(e)[:k] for _ in range(n)])
    ee = torch.from_numpy(eids.reshape(-1))
    order = torch.argsort(ee, stable=True)
    terms = (rng.standard_normal((n * k, d))
             * 10.0 ** rng.integers(-3, 4, (n * k, 1))).astype(np.float32)
    got = moe._combine(torch.from_numpy(terms)[order], order, n, k).numpy()
    want = np.zeros((n, d), np.float32)
    topk = np.zeros((n, d), np.float32)
    for t in range(n):
        for j in np.argsort(eids[t]):
            want[t] = want[t] + terms[t * k + j]
        for j in range(k):
            topk[t] = topk[t] + terms[t * k + j]
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(got, topk)
