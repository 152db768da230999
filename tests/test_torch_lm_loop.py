"""The port's ``train lm`` loop and CLI against the JAX reference's
``repro.launch.train.run_lm`` on the CPU: the loop from the reference's
initial state for gemma3 (banded attention), mamba2 (SSD) and qwen3-moe
(MoE), the CLI on every decoder smoke arch and its flag errors.

States start from the reference's: its stacked params and int8 masks (the
setup of ``tests/test_scale_steps.py``) or, for the ``lm`` loop, the
initial params and masks its ``run_lm`` draws from ``PRNGKey(seed)``,
carried across as numpy arrays.  Values are held to ``1e-5 *
max(1, max|ref|)``; masks, tokens and corpora exactly.
"""
import argparse
import contextlib
import io
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.masks import init_mask as ref_init_mask
from repro.launch import train as ref_train
from repro.models import bind as ref_bind
from repro_torch import configs
from repro_torch.checkpoint.npz import tree_from_numpy
from repro_torch.core.gossip import gossip_average_stacked
from repro_torch.core.gossip import plain_gossip_stacked
from repro_torch.data.synthetic import make_lm_corpus
from repro_torch.launch import steps
from repro_torch.launch import train
from repro_torch.models import bind
from repro_torch.utils.tree import tree_leaves_with_path

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


def _ref_initial_state(args):
    """What the reference's ``run_lm`` draws before its loop: each client's
    params and its ERK mask from ``PRNGKey(seed)``, unmasked params."""
    base = ref_configs.SMOKE_ARCHS[args.arch]
    cfg = base.replace(d_model=args.d_model,
                       n_layers=max(base.n_layers, args.layers), vocab=256)
    api = ref_bind(cfg, remat=False)
    keys = jax.random.split(jax.random.PRNGKey(args.seed), 2 * args.clients)
    params = [api.init(keys[i]) for i in range(args.clients)]
    masks = [ref_init_mask(keys[args.clients + i], params[i], args.density)
             for i in range(args.clients)]
    return [_np(p) for p in params], [_np(m) for m in masks]


def _strip_times(text):
    return re.sub(r" \(\d+s\)", "", text).splitlines()


@pytest.mark.parametrize("name", ["gemma3-1b", "mamba2-1.3b",
                                  "qwen3-moe-30b-a3b"])
def test_lm_loop_matches_reference_run_lm(name):
    """The port's loop from the reference's initial state (banded
    attention, SSD, MoE): loss history, printed lines and ``improved``."""
    args = train.parse_args(LOOP_ARGV + ["--arch", name, "--device", "cpu"])
    ref_args = argparse.Namespace(**{k: v for k, v in vars(args).items()
                                     if k not in ("mode", "device")})
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        want = ref_train.run_lm(ref_args)
    params, masks = _ref_initial_state(ref_args)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got, state = train.lm_loop(args, train.lm_config(args),
                                   [tree_from_numpy(p) for p in params],
                                   [tree_from_numpy(m) for m in masks],
                                   torch.device("cpu"))
    assert got["arch"] == want["arch"]
    assert got["improved"] == want["improved"]
    hist, ref_hist = np.array(got["loss_history"]), np.array(
        want["loss_history"])
    assert hist.shape == ref_hist.shape == (3,)
    rel = np.abs(hist - ref_hist) / np.abs(ref_hist)
    exact = CHAOTIC_ROUNDS.get(name, 3)
    assert np.all(rel[:exact] <= TOL), rel
    assert np.all(rel[exact:] <= CHAOTIC_TOL), rel
    lines, ref_lines = _strip_times(out.getvalue()), _strip_times(
        ref_out.getvalue())
    assert lines[0] == ref_lines[0]                     # arch, size, density
    assert lines[-1] == ref_lines[-1]                   # the JSON
    assert json.loads(lines[-1]) == {"arch": want["arch"],
                                     "improved": want["improved"]}
    if name not in CHAOTIC_ROUNDS:
        assert lines == ref_lines
    # the final state: masked params, masks holding client 0's ERK budgets
    for (path, w), (_, m) in zip(tree_leaves_with_path(state["params"]),
                                 tree_leaves_with_path(state["masks"])):
        assert w.shape[0] == m.shape[0] == 2, path
        assert bool(torch.all(w[m == 0] == 0)), path


@pytest.mark.parametrize("name", sorted(
    n for n, c in configs.SMOKE_ARCHS.items() if c.enc_layers == 0))
def test_lm_cli_runs_every_decoder_arch_on_the_cpu(name, capsys):
    out = train.main(["lm", "--device", "cpu", "--arch", name, "--clients",
                      "2", "--rounds", "2", "--steps", "2", "--seq", "16",
                      "--batch-size", "1", "--tokens-per-client", "256",
                      "--d-model", "64"])
    assert out["arch"] == f"{name}-smoke"
    assert len(out["loss_history"]) == 2
    assert np.all(np.isfinite(out["loss_history"]))
    text = capsys.readouterr().out.splitlines()
    assert text[0].startswith(f"[lm] arch={name}-smoke params/client=")
    assert json.loads(text[-1]) == {"arch": out["arch"],
                                    "improved": out["improved"]}


def test_lm_cli_flag_errors(capsys):
    with pytest.raises(SystemExit):
        train.parse_args(["lm", "--arch", "seamless-m4t-large-v2"])
    assert "encoder-decoder" in capsys.readouterr().err
    with pytest.raises(ValueError, match="encoder-decoder"):
        train.lm_config(train.build_parser().parse_args(
            ["lm", "--arch", "seamless-m4t-large-v2"]))
    with pytest.raises(KeyError):                       # as the reference
        train.parse_args(["lm", "--arch", "nope"])
    for bad in (["--device", "tpu"], ["--scale"], ["--strategy", "dispfl"],
                ["--clients", "two"]):
        with pytest.raises(SystemExit):
            train.parse_args(["lm", *bad])
    args = train.parse_args(["lm"])
    assert (args.arch, args.clients, args.steps, args.rounds, args.seq,
            args.batch_size, args.lr, args.density, args.d_model,
            args.layers, args.tokens_per_client, args.seed, args.device) == (
        "qwen3-8b", 4, 100, 10, 128, 8, 0.05, 0.5, 256, 2, 32768, 0, "cuda")


def test_lm_cli_refuses_to_start_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["lm", "--arch", "qwen3-8b", "--clients", "2"])
