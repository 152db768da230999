"""Rematerialisation in the port (``repro_torch.models.remat``,
``bind(remat=..., remat_policy=...)``, ``launch.dryrun --remat``) on the
CPU.

- ``"full"`` and ``"dots"`` against ``remat=False``, bit for bit: the loss
  and every gradient leaf of K=2 smoke-arch clients of one 16-token row,
  through both of the steps' forms (``steps.stacked_loss_grads``'
  ``grad(vmap)`` and the mask update's ``vmap(grad)``), on the nine
  decoder smoke archs (the encoder-decoder takes ``"full"`` only, as the
  reference's); one arch at bf16; the mask update step's params and
  masks.  The matmul FLOPs each form dispatches: ``"dots"`` equal to
  ``remat=False``'s (its recompute replays the forward's matmuls),
  ``"full"`` above them.
- The port's ``"full"`` against the reference's ``bind(remat=True)``
  (``jax.checkpoint`` in its block scan): loss and gradients within
  ``1e-5 * max(1, max|ref|)`` on gemma3-1b, qwen3-moe, mamba2, jamba and
  seamless.
- The dry run of gemma3-1b at published width, ``train_4k`` (K=2 x one
  row, bf16) on CPU fake tensors: FLOPs(``full``) - FLOPs(``none``) =
  n_blocks x one block's forward FLOPs, FLOPs(``dots``) =
  FLOPs(``none``), and peak live bytes ``full`` < ``dots`` <= ``none``.
- An unknown policy raises, a ``"dots"`` recompute that departs from its
  forward raises, and the dry run's records carry the reference's
  ``__remat_<p>`` tags, which ``launch.report`` tables apart.

The meshed train step under ``"full"`` is ``test_torch_mesh_steps.py``'s.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from _torch_threads import one_torch_thread  # noqa: F401
from repro import configs as ref_configs
from repro.models import bind as ref_bind
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch import configs
from repro_torch.checkpoint.npz import tree_from_numpy
from repro_torch.launch import dryrun, report, steps
from repro_torch.models import bind, lm, remat
from repro_torch.utils.tree import tree_leaves_with_path, tree_map, tree_stack

pytestmark = pytest.mark.tier1

K, ROWS, SEQ = 2, 1, 16
TOL = 1e-5
DECODERS = [n for n, c in configs.SMOKE_ARCHS.items() if c.enc_layers == 0]
ENCDEC = "seamless-m4t-large-v2"
FORMS = ("grad(vmap)", "vmap(grad)")


def _batch(cfg, k=None, seed=0, dtype=torch.float32):
    """A train batch of ROWS x SEQ (K clients stacked in front where ``k``
    is given), drawn with numpy: tokens and labels in the vocabulary,
    a VLM's prefix and an audio model's frames ~ N(0, 1)."""
    shape = dataclasses.replace(configs.INPUT_SHAPES["train_4k"],
                                seq_len=SEQ, global_batch=ROWS)
    specs = bind(cfg, remat=False).input_specs(shape, dtype, batch=ROWS)
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)

    def draw(s):
        size = lead + tuple(s.shape)
        if s.dtype == torch.int32:
            return torch.from_numpy(
                rng.integers(0, cfg.vocab, size).astype(np.int32))
        return torch.from_numpy(
            rng.standard_normal(size).astype(np.float32)).to(s.dtype)

    return {name: draw(s) for name, s in specs.items()}


def _grads(api, params, batch, form):
    """``(grads, losses)`` of the K clients' ``train_loss`` in one of the
    steps' two forms."""
    if form == "grad(vmap)":
        return steps.stacked_loss_grads(api)(params, batch)
    per = torch.func.vmap(torch.func.grad_and_value(
        lambda p, b: api.train_loss(p, b)[0]))
    return per(params, batch)


_runs: dict = {}


def _run(name, policy, form, dtype=torch.float32):
    """The K clients' gradients and losses of smoke ``name`` under
    ``policy`` ("none": ``remat=False``) in ``form``, and the FLOPs the
    call dispatched; cached per case."""
    key = (name, policy, form, dtype)
    if key not in _runs:
        cfg = configs.SMOKE_ARCHS[name]
        api = bind(cfg, remat=policy != "none",
                   remat_policy="full" if policy == "none" else policy)
        gen = torch.Generator().manual_seed(0)
        params = tree_stack([api.init(gen, dtype) for _ in range(K)])
        flops = FlopCounterMode(display=False)
        with flops:
            grads, losses = _grads(api, params, _batch(cfg, K, dtype=dtype),
                                   form)
        _runs[key] = (grads, losses, flops.get_total_flops())
    return _runs[key]


def _assert_same_bits(got, want, what):
    (g_grads, g_losses, _), (w_grads, w_losses, _) = got, want
    assert torch.equal(g_losses, w_losses), what
    a, b = tree_leaves_with_path(g_grads), tree_leaves_with_path(w_grads)
    assert [p for p, _ in a] == [p for p, _ in b], what
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what} {path}"


CASES = ([(n, p) for n in DECODERS for p in remat.POLICIES]
         + [(ENCDEC, "full")])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name,policy", CASES)
def test_remat_is_bit_equal_to_none(name, policy, form):
    got = _run(name, policy, form)
    want = _run(name, "none", form)
    _assert_same_bits(got, want, f"{name} {policy} {form}")
    if policy == "dots":
        assert got[2] == want[2]
    else:
        assert got[2] > want[2]


@pytest.mark.parametrize("policy", remat.POLICIES)
def test_remat_is_bit_equal_to_none_at_bf16(policy):
    form = "grad(vmap)"
    got = _run("gemma3-1b", policy, form, torch.bfloat16)
    want = _run("gemma3-1b", "none", form, torch.bfloat16)
    assert next(iter(tree_leaves_with_path(got[0])))[1].dtype == \
        torch.bfloat16
    _assert_same_bits(got, want, f"bf16 {policy}")


@pytest.mark.parametrize("policy", remat.POLICIES)
def test_mask_update_step_is_bit_equal_to_none(policy):
    """The mask update step (dense ``vmap(grad)``, then prune and regrow)
    returns the same params and masks under each policy."""
    cfg = configs.SMOKE_ARCHS["qwen3-moe-30b-a3b"]
    shape = dataclasses.replace(configs.INPUT_SHAPES["train_4k"],
                                seq_len=SEQ, global_batch=K * ROWS)
    plan = steps.ScalePlan(cfg, shape, K, ROWS)
    gen = torch.Generator().manual_seed(1)
    params = tree_stack([bind(cfg).init(gen) for _ in range(K)])
    masks = tree_map(lambda w: (torch.rand(w.shape, generator=gen) < 0.5)
                     .to(torch.int8), params)
    batch = _batch(cfg, K, seed=2)
    out = {}
    for name, kw in (("none", {"remat": False}),
                     (policy, {"remat_policy": policy})):
        out[name] = steps.make_mask_update_step(
            bind(cfg, **kw), plan, density=0.5)(params, masks, batch, 0.3)
    for want, got in zip(out["none"], out[policy]):
        for (path, a), (_, b) in zip(tree_leaves_with_path(got),
                                     tree_leaves_with_path(want)):
            assert torch.equal(a, b), (policy, path)


def _assert_close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: max abs err {err} > {TOL} x {scale}"


@pytest.mark.parametrize("name", ["gemma3-1b", "qwen3-moe-30b-a3b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b",
                                  ENCDEC])
def test_full_matches_the_reference_remat(name):
    """One client's ``train_loss`` and its gradients: the port's ``"full"``
    against the reference's ``bind(remat=True)`` from the same params."""
    api = ref_bind(ref_configs.SMOKE_ARCHS[name], remat=True)
    params = api.init(jax.random.PRNGKey(0))
    batch = _batch(configs.SMOKE_ARCHS[name], seed=4)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        api.train_loss, has_aux=True))(
        params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    port = bind(configs.SMOKE_ARCHS[name], remat=True, remat_policy="full")
    got, (got_loss, _) = torch.func.grad_and_value(
        port.train_loss, has_aux=True)(
        tree_from_numpy(jax.tree.map(np.asarray, params)), batch)
    _assert_close(got_loss, np.float32(loss), f"{name} loss")
    ra, pa = ref_leaves(grads), tree_leaves_with_path(got)
    assert [p for p, _ in ra] == [p for p, _ in pa]
    for (path, want), (_, g) in zip(ra, pa):
        _assert_close(g, np.asarray(want), f"{name} grad {path}")


def test_unknown_policies_raise_and_nothing_falls_back():
    cfg = configs.SMOKE_ARCHS["qwen3-8b"]
    with pytest.raises(ValueError, match="remat_policy must be one of"):
        bind(cfg, remat_policy="none")
    with pytest.raises(ValueError, match="remat_policy must be one of"):
        bind(configs.SMOKE_ARCHS[ENCDEC], remat=False, remat_policy="x")
    with pytest.raises(ValueError, match="remat_policy must be one of"):
        remat.checkpoint(lambda x: (x,), (torch.ones(2),), "offload")
    with pytest.raises(ValueError, match="remat must be one of"):
        dryrun.remat_options("bogus")
    assert dryrun.remat_options("none") == {"remat": False,
                                            "remat_policy": "full"}


def test_dots_recompute_that_departs_from_its_forward_raises():
    """``"dots"`` hands the recompute the forward's matmul outputs in
    order; a recompute asking for other matmuls is refused, not run."""
    calls = []

    def fn(x, w):
        calls.append(1)
        y = x @ w
        return (torch.tanh(y @ w.T if len(calls) > 1 else y),)

    x, w = torch.randn(3, 4), torch.randn(4, 4)
    with pytest.raises(RuntimeError, match="remat 'dots'"):
        torch.func.grad(lambda x, w: remat.checkpoint(
            fn, (x, w), "dots")[0].sum())(x, w)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def published():
    """gemma3-1b at published width, ``train_4k``, K=2 x one row, bf16:
    each ``--remat`` value's ``StepCost`` on CPU fakes, and one block's
    forward FLOPs (K clients, vmapped)."""
    cfg = configs.ARCHS["gemma3-1b"]
    plan = dryrun.make_plan(cfg, configs.INPUT_SHAPES["train_4k"], 2, 1,
                            "bf16")
    costs = {r: dryrun.trace_plan(plan, device="cpu", remat=r)[0]
             for r in dryrun.REMAT}
    prelude, period, n_blocks, _, kinds = lm.layer_plan(cfg)
    start = len(prelude)

    def block(x, positions, bp):
        for j in range(period):
            x, _, _ = lm.layer_apply(bp[f"p{j}"], x, kinds[start + j], cfg,
                                     positions)
        return x

    blocks = steps.abstract_params(bind(cfg), plan)["blocks"]
    s = plan.shape.seq_len
    with FakeTensorMode():
        bp = tree_map(lambda t: torch.empty(
            (t.shape[0],) + tuple(t.shape[2:]), dtype=t.dtype), blocks)
        x = torch.empty((plan.n_clients, plan.per_client_batch, s,
                         cfg.d_model), dtype=plan.dtype)
        positions = torch.arange(s)[None, :].expand(plan.per_client_batch, s)
        flops = FlopCounterMode(display=False)
        with flops:
            torch.func.vmap(block, in_dims=(0, None, 0))(x, positions, bp)
    return {"costs": costs, "n_blocks": n_blocks,
            "block_flops": flops.get_total_flops()}


def test_dryrun_full_adds_one_forward_of_the_blocks(published):
    c = published["costs"]
    assert published["n_blocks"] == 4 and published["block_flops"] > 0
    assert c["full"].flops - c["none"].flops == (
        published["n_blocks"] * published["block_flops"])


def test_dryrun_dots_keeps_the_matmul_flops(published):
    c = published["costs"]
    assert c["dots"].flops == c["none"].flops
    assert c["dots"].bytes_accessed > c["none"].bytes_accessed


def test_dryrun_peak_is_lowest_under_full(published):
    c = published["costs"]
    assert c["full"].peak_live_bytes < c["none"].peak_live_bytes
    assert (c["full"].peak_live_bytes <= c["dots"].peak_live_bytes
            <= c["none"].peak_live_bytes)
    assert len({c[r].argument_bytes for r in dryrun.REMAT}) == 1


def test_dryrun_writes_the_reference_remat_tags(tmp_path, capsys):
    out = str(tmp_path)
    for r in dryrun.REMAT:
        dryrun.main(["--smoke", "--arch", "qwen3-8b", "--shape", "train_4k",
                     "--device", "cpu", "--remat", r, "--out", out])
    names = sorted(os.listdir(out))
    assert names == ["qwen3-8b__train_4k__testh100x1.json",
                     "qwen3-8b__train_4k__testh100x1__remat_dots.json",
                     "qwen3-8b__train_4k__testh100x1__remat_none.json"]
    recs = {}
    for n in names:
        with open(os.path.join(out, n)) as f:
            rec = json.load(f)
        recs[rec["remat"]] = rec
        # a published-width record of the same program, for the report
        rec.update(mesh="h100x1", smoke=False,
                   tag=rec["tag"].replace("testh100x1", "h100x1"))
        with open(os.path.join(out, "pub_" + n), "w") as f:
            json.dump(rec, f)
    assert recs["full"]["cost"]["flops"] > recs["none"]["cost"]["flops"]
    assert recs["dots"]["cost"]["flops"] == recs["none"]["cost"]["flops"]
    capsys.readouterr()
    rows = [r for r in report.fit_table(report.load_records(out)).splitlines()
            if r.startswith("| qwen3-8b")]
    assert sorted(r.split(" | ")[0] for r in rows) == [
        "| qwen3-8b", "| qwen3-8b [remat dots]", "| qwen3-8b [remat none]"]
