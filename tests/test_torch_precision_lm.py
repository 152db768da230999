"""The port's LM families at bf16 (``init(gen, torch.bfloat16)``, bf16
caches and inputs) against the JAX reference at bf16 on the CPU.

The reference's bf16 params (``api.init(key, jnp.bfloat16)``) cross into
the port bit for bit as ``ml_dtypes.bfloat16`` arrays
(``checkpoint.npz.tree_from_numpy``).  Compared, for the nine decoder
smoke archs at 2 users: the prefill's last-position logits and its caches
(4-token prompts), one greedy decode step's logits, and ``train_loss`` on
8 tokens; for seamless the prefill only, as its serving path runs it.

Tolerances, stated with what the tests observe (each prints its gap:
``pytest -rP``; ROADMAP Queue C):

* logits, caches and decode logits: ``max|port - ref| <= BF16_TOL *
  max(1, max|ref|)`` with ``BF16_TOL = 5e-2``, the reference's own bf16
  tolerance for its kernels (``tests/test_kernels.py``).  Observed at most
  3.1e-2 (jamba's prefill logits and caches), 2.5e-2 (decode); mamba2 0
  (its SSD runs in fp32 islands).  XLA on the CPU runs a chain of
  elementwise bf16 ops in fp32 and rounds once, eager torch rounds after
  each op, so the two differ by bf16 ulps from the first layer on, and
  the differences grow through the layers.
* ``train_loss`` (fp32 from bf16 logits): within ``2^-8`` relative (one
  bf16 unit roundoff); observed at most 9.5e-4.
* the bf16 port against the fp32 port from the same (bf16) weights:
  within ``BF16_TOL`` too; observed at most 2.5e-2 — the port's gap to
  the reference is the size of bf16's own rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import bind as ref_bind
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch import configs
from repro_torch.checkpoint.npz import to_numpy, tree_from_numpy
from repro_torch.models import bind
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

pytestmark = pytest.mark.tier1

BF16_TOL = 5e-2
LOSS_RTOL = 2.0 ** -8
ARCHS = sorted(configs.SMOKE_ARCHS)
DECODER_ARCHS = [a for a in ARCHS if configs.SMOKE_ARCHS[a].enc_layers == 0]
ROWS, PROMPT, SEQ, ENC_LEN = 2, 4, 8, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager forwards of tiny models, hundreds of small ops each: under the
    suite's parallel workers torch's intra-op threads only contend for the
    cores, so the module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16(batch):
    """Float inputs (prefix, frames) as the reference's bf16 arrays."""
    return {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
            if v.dtype == np.float32 else v for k, v in batch.items()}


def err_at_scale(got, want) -> float:
    """``max|got - want| / max(1, max|want|)``, in fp32."""
    if isinstance(got, torch.Tensor):
        got = to_numpy(got)
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return (float(np.abs(got - want).max(initial=0.0))
            / max(1.0, float(np.abs(want).max(initial=0.0))))


def _inputs(cfg):
    """A 4-token prompt (with the VLM's prefix or the audio model's
    frames) and an 8-token training batch (labels -1 over a prefix)."""
    rng = np.random.default_rng(0)
    prompt = {"tokens": rng.integers(0, cfg.vocab, (ROWS, PROMPT))}
    kw = {}
    if cfg.prefix_len:
        prompt["prefix"] = rng.standard_normal(
            (ROWS, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        prompt["frames"] = rng.standard_normal(
            (ROWS, ENC_LEN, cfg.d_model)).astype(np.float32)
        kw["enc_len"] = ENC_LEN
    n_text = SEQ - cfg.prefix_len
    train = {"tokens": rng.integers(0, cfg.vocab, (ROWS, n_text)),
             "labels": rng.integers(0, cfg.vocab, (ROWS, SEQ))}
    if cfg.prefix_len:
        train["prefix"] = prompt["prefix"]
        train["labels"][:, :cfg.prefix_len] = -1
    for b in (prompt, train):
        for k in ("tokens", "labels"):
            if k in b:
                b[k] = b[k].astype(np.int32)
    return _bf16(prompt), _bf16(train), kw


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """One smoke arch at bf16: the reference's params, its prefill (logits,
    caches), one greedy decode step and ``train_loss``, built once."""
    name = request.param
    cfg = ref_configs.SMOKE_ARCHS[name]
    api = ref_bind(cfg, remat=False)
    params = api.init(jax.random.PRNGKey(0), jnp.bfloat16)
    prompt, train, kw = _inputs(cfg)
    max_len = PROMPT + cfg.prefix_len + 1
    cache = api.init_cache(ROWS, max_len, jnp.bfloat16, **kw)
    logits, cache = jax.jit(api.prefill)(
        params, jax.tree.map(jnp.asarray, prompt), cache)
    out = {"name": name, "params": _np(params), "prompt": prompt,
           "train": train, "kw": kw, "max_len": max_len,
           "logits": np.asarray(logits), "cache": _np(cache)}
    if not cfg.enc_layers:
        tok = jnp.argmax(logits[:, -1].astype(jnp.float32), -1)[:, None]
        pos = PROMPT + cfg.prefix_len
        dec, _ = jax.jit(api.decode)(params, tok.astype(jnp.int32),
                                     jnp.int32(pos), cache)
        loss, _ = jax.jit(api.train_loss)(
            params, jax.tree.map(jnp.asarray, train))
        out.update(tok=np.asarray(tok, np.int32), pos=pos,
                   decode=np.asarray(dec), loss=float(loss))
    return out


def _port_prefill(arch, dtype=torch.bfloat16):
    cfg = configs.SMOKE_ARCHS[arch["name"]]
    api = bind(cfg)
    params = tree_from_numpy(arch["params"])
    prompt = tree_from_numpy(arch["prompt"])
    if dtype != torch.bfloat16:
        params, prompt = (tree_map(lambda t: t.to(dtype) if
                                   t.is_floating_point() else t, tree)
                          for tree in (params, prompt))
    cache = api.init_cache(ROWS, arch["max_len"], dtype, **arch["kw"])
    with torch.no_grad():
        logits, cache = api.prefill(params, prompt, cache)
    return api, params, logits, cache


def test_bf16_init_cache_and_leaves_match_reference(arch):
    """``init(gen, bf16)`` and ``init_cache(..., bf16)`` give the
    reference's leaf paths, shapes and dtypes (fp32 islands included:
    the MoE router, the SSM's A_log/D/dt_bias and SSD state)."""
    cfg = configs.SMOKE_ARCHS[arch["name"]]
    api = bind(cfg)
    port = api.init(torch.Generator().manual_seed(0), torch.bfloat16)
    ra, pa = ref_leaves(arch["params"]), tree_leaves_with_path(port)
    assert [p for p, _ in ra] == [p for p, _ in pa]
    for (path, x), (_, y) in zip(ra, pa):
        assert tuple(x.shape) == tuple(y.shape), path
        assert to_numpy(torch.zeros((), dtype=y.dtype)).dtype == x.dtype, path
    cache = api.init_cache(ROWS, arch["max_len"], torch.bfloat16, **arch["kw"])
    rc, pc = ref_leaves(arch["cache"]), tree_leaves_with_path(cache)
    assert [p for p, _ in rc] == [p for p, _ in pc]
    for (path, x), (_, y) in zip(rc, pc):
        assert to_numpy(torch.zeros((), dtype=y.dtype)).dtype == x.dtype, path


def test_bf16_prefill_matches_reference(arch):
    _, _, logits, cache = _port_prefill(arch)
    assert logits.dtype == torch.bfloat16
    gap = err_at_scale(logits, arch["logits"])
    assert gap <= BF16_TOL
    rc, pc = ref_leaves(arch["cache"]), tree_leaves_with_path(cache)
    assert [p for p, _ in rc] == [p for p, _ in pc]
    cache_gap = 0.0
    for (path, x), (_, y) in zip(rc, pc):
        cache_gap = max(cache_gap, err_at_scale(y, x))
        assert err_at_scale(y, x) <= BF16_TOL, path
    print(f"{arch['name']}: bf16 prefill logits {gap:.3g}, caches "
          f"{cache_gap:.3g} of scale from the reference's")


def test_bf16_prefill_within_bf16_of_fp32_port(arch):
    """The bf16 port against the fp32 port from the same weights."""
    _, _, logits, _ = _port_prefill(arch)
    _, _, f32, _ = _port_prefill(arch, torch.float32)
    assert f32.dtype == torch.float32
    gap = err_at_scale(logits, to_numpy(f32))
    assert gap <= BF16_TOL
    print(f"{arch['name']}: bf16 prefill logits {gap:.3g} of scale from the "
          f"fp32 port's")


@pytest.mark.parametrize("arch", DECODER_ARCHS, indirect=True)
def test_bf16_decode_step_matches_reference(arch):
    api, params, _, cache = _port_prefill(arch)
    with torch.no_grad():
        logits, new_cache = api.decode(
            params, torch.from_numpy(arch["tok"].copy()),
            torch.tensor(arch["pos"], dtype=torch.int32), cache)
    assert logits.dtype == torch.bfloat16
    gap = err_at_scale(logits, arch["decode"])
    assert gap <= BF16_TOL
    print(f"{arch['name']}: bf16 decode logits {gap:.3g} of scale from the "
          f"reference's")


@pytest.mark.parametrize("arch", DECODER_ARCHS, indirect=True)
def test_bf16_train_loss_matches_reference(arch):
    api = bind(configs.SMOKE_ARCHS[arch["name"]], remat=False)
    with torch.no_grad():
        loss, metrics = api.train_loss(tree_from_numpy(arch["params"]),
                                       tree_from_numpy(arch["train"]))
    assert loss.dtype == torch.float32
    gap = abs(float(loss) - arch["loss"]) / max(1.0, abs(arch["loss"]))
    assert gap <= LOSS_RTOL
    print(f"{arch['name']}: bf16 train_loss {gap:.3g} relative from the "
          f"reference's")
