"""The reference's public surface in the port, on the CPU.

Every module of ``src/repro`` (``pkgutil.walk_packages``, plus the
``launch`` directory, which has no ``__init__``) is held against its
counterpart under ``repro_torch``: each public name the module defines at
its top level, or that a package's ``__init__`` re-exports, must exist
there.  Only two kinds of exception stand, each with its reason:
``RENAMED`` (the port's name for the same role) and ``NOT_PORTED``
(modules and names that exist for a TPU mesh or for ``jax`` alone).

Then the functions the port gained for this surface, from the same numpy
inputs through both packages: the deterministic ones bit for bit
(``tree_bytes``, the tree arithmetic, ``mask_density``,
``tree_packed_coords``, both ``count_params``, ``select_by_path``,
``path_str``, ``check_finite``, ``apply_updates`` and both block masks),
``tree_dot`` and ``tree_l2`` to fp32 rounding, and ``load_clients``
across the packages' ``save_clients`` directories.  The functions that
draw (``init_client_masks``, ``dispfl_state``, ``split_like``) take a
``torch.Generator`` and cannot replay ``jax.random``: they are held to
the reference's shapes, dtypes and ERK densities.
"""
import ast
import importlib
import os
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
REF_ROOT = os.path.join(SRC, "repro")

#: reference name -> (the port's name for it, why it differs)
RENAMED = {
    "repro.kernels.gossip_avg.gossip_avg_flat": (
        "repro_torch.kernels.gossip_avg.gossip_avg",
        "the CUDA wrapper takes the (J, N) rows as a list, no flat stack"),
    "repro.kernels.packed_accum.packed_accum_flat": (
        "repro_torch.kernels.packed_accum.packed_accum",
        "one flat fold; the port has no other flat form to tell it from"),
    "repro.kernels.prune_regrow.prune_regrow_flat": (
        "repro_torch.kernels.prune_regrow.prune_regrow_rows",
        "the CUDA kernel takes K rows with per-row thresholds"),
    "repro.obs.install_jax_hooks": (
        "repro_torch.obs.install_torch_hooks",
        "the port counts nvcc builds and torch.compile graphs, not jax's"),
    "repro.obs.jax_compile_count": (
        "repro_torch.obs.torch_compile_count",
        "torch.compile's graphs stand where jax's compiles stood"),
    "repro.obs.counters.install_jax_hooks": (
        "repro_torch.obs.counters.install_torch_hooks",
        "the port counts nvcc builds and torch.compile graphs, not jax's"),
    "repro.obs.counters.jax_compile_count": (
        "repro_torch.obs.counters.torch_compile_count",
        "torch.compile's graphs stand where jax's compiles stood"),
    "repro.launch.roofline.PEAK_FLOPS": (
        "repro_torch.launch.roofline.PEAK_FLOPS_BY_DTYPE",
        "the H100's peak differs by dtype (bf16 tensor cores, fp32)"),
    "repro.launch.roofline.ICI_BW": (
        "repro_torch.launch.roofline.LINK_BW",
        "NVLink stands where the TPU's inter-chip link stood"),
    "repro.utils.hlo.op_histogram": (
        "repro_torch.utils.trace_cost.step_cost",
        "the aten-op histogram is StepCost.aten_ops, counted in the pass "
        "that counts the step's bytes"),
}

#: reference module -> (the port's module in its role, why it differs)
RENAMED_MODULES = {
    "repro.utils.hlo": (
        "repro_torch.utils.collectives",
        "no HLO: a meshed step's collectives are counted from the c10d and "
        "functional-collective ops one rank dispatches"),
}
_TPU_TILE = "the Pallas kernel's TPU tile; the CUDA tile is in csrc"
_ALIAS = "a type alias the reference module defines and never uses"

#: reference module or name -> why the port has none
NOT_PORTED = {
    "repro.launch.mesh.AxisType": "jax's mesh axis kind (Auto); a "
                                  "DeviceMesh has none",
    "repro.kernels.ops": "the port's kernel wrappers pad nothing and "
                         "stand in its place",
    "repro.kernels.ref": "each kernel module's *_plain functions are the "
                         "oracles",
    "repro.kernels.gossip_avg.BLOCK_N": _TPU_TILE,
    "repro.kernels.prune_regrow.BLOCK": _TPU_TILE,
    "repro.kernels.masked_matmul.DEFAULT_BM": _TPU_TILE,
    "repro.kernels.masked_matmul.DEFAULT_BN": _TPU_TILE,
    "repro.kernels.masked_matmul.DEFAULT_BK": _TPU_TILE,
    "repro.obs.counters.JAX_COMPILE_EVENT": "the jax.monitoring event "
                                            "name; torch has no such event",
    "repro.launch.dryrun.DOC": "the multi-pod dry run's help; the port's "
                               "is its module docstring",
    "repro.launch.report.UNROLL_DIR": "--unroll is refused (README A13d)",
    "repro.core.accounting.PyTree": _ALIAS,
    "repro.models.common.PyTree": _ALIAS,
    "repro.models.registry.PyTree": _ALIAS,
    "repro.serve.engine.PyTree": _ALIAS,
}


def _module_files() -> list[str]:
    """Every reference module, named from its file (no import)."""
    out = []
    for dirpath, _, files in os.walk(REF_ROOT):
        rel = os.path.relpath(dirpath, SRC).replace(os.sep, ".")
        for f in files:
            if f.endswith(".py"):
                out.append(rel if f == "__init__.py" else f"{rel}.{f[:-3]}")
    return sorted(out)


MODULES = _module_files()


def _walked() -> set[str]:
    """``pkgutil.walk_packages`` over the reference, and over each
    directory without an ``__init__`` (a namespace it does not enter)."""
    import repro

    names = {m.name for m in pkgutil.walk_packages(repro.__path__, "repro.")}
    for dirpath, _, files in os.walk(REF_ROOT):
        if "__init__.py" not in files and dirpath != REF_ROOT:
            pkg = os.path.relpath(dirpath, SRC).replace(os.sep, ".")
            names |= {m.name for m in pkgutil.walk_packages([dirpath],
                                                            pkg + ".")}
    return names


def _public(mod) -> list[str]:
    """Names ``mod`` defines at its top level (functions, classes,
    assignments, also under a top-level ``if``/``try``), its ``__all__``,
    and, for a package, what its ``__init__`` imports."""
    tree = ast.parse(open(mod.__file__).read())
    package = mod.__file__.endswith("__init__.py")
    names = set(getattr(mod, "__all__", ()))

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(n.id for t in node.targets for n in ast.walk(t)
                             if isinstance(n, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                names.add(node.target.id)
            elif package and isinstance(node, ast.ImportFrom):
                names.update(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for h in node.handlers:
                    visit(h.body)

    visit(tree.body)
    return sorted(n for n in names if not n.startswith("_"))


def _resolve(dotted: str):
    mod, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(mod), name)


def test_the_walk_covers_every_reference_module():
    assert _walked() == set(MODULES)
    assert len(MODULES) == 93


@pytest.mark.parametrize("name", MODULES)
def test_reference_module_surface_in_the_port(name):
    port_name = RENAMED_MODULES.get(name, ("repro_torch" + name[len("repro"):],
                                           None))[0]
    if name in NOT_PORTED:
        assert NOT_PORTED[name]
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(port_name)
        return
    ref = importlib.import_module(name)
    port = importlib.import_module(port_name)
    missing = []
    for n in _public(ref):
        key = f"{name}.{n}"
        if key in RENAMED:
            assert not hasattr(port, n), f"{key} is in RENAMED but ported"
            _resolve(RENAMED[key][0])
        elif key in NOT_PORTED:
            assert not hasattr(port, n), f"{key} is in NOT_PORTED but ported"
        elif not hasattr(port, n):
            missing.append(n)
    assert not missing, f"{port_name} lacks {missing}"


def test_exception_tables_name_reference_names():
    """Every table entry is a reference module or a public name of one."""
    for _, reason in RENAMED_MODULES.values():
        assert reason
    assert set(RENAMED_MODULES) <= set(MODULES)
    for key in list(RENAMED) + list(NOT_PORTED):
        assert (RENAMED.get(key) or (None, NOT_PORTED.get(key)))[1]
        if key in MODULES:
            continue
        mod, _, n = key.rpartition(".")
        assert mod in MODULES and n in _public(importlib.import_module(mod))


# ---------------------------------------------------------------------------
# the new functions against the reference's
# ---------------------------------------------------------------------------


def _trees(seed=0):
    """Two float32 trees of one structure (numpy), nested as the models'."""
    rng = np.random.default_rng(seed)

    def one():
        return {"conv": {"w": rng.standard_normal((3, 3, 4, 8)
                                                  ).astype(np.float32),
                         "b": rng.standard_normal(8).astype(np.float32)},
                "fc": {"w": rng.standard_normal((16, 10)).astype(np.float32)},
                "blocks": [rng.standard_normal((5, 7)).astype(np.float32),
                           rng.standard_normal(3).astype(np.float32)]}

    return one(), one()


def _j(t):
    return jax.tree.map(jnp.asarray, t)


def _t(t):
    from repro_torch.checkpoint.npz import tree_from_numpy
    return tree_from_numpy(t)


def pt_leaves(t):
    from repro_torch.utils.tree import tree_leaves
    return tree_leaves(t)


def _bits_equal(ref_tree, port_tree):
    a = [np.asarray(x) for x in jax.tree.leaves(ref_tree)]
    b = [x.numpy() for x in pt_leaves(port_tree)]
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(a, b))


@pytest.mark.parametrize("fn", ["tree_add", "tree_sub", "tree_mul"])
def test_tree_arithmetic_bit_for_bit(fn):
    from repro.utils import tree as rt
    from repro_torch.utils import tree as pt
    a, b = _trees()
    assert _bits_equal(getattr(rt, fn)(_j(a), _j(b)),
                       getattr(pt, fn)(_t(a), _t(b)))


def test_tree_scale_cast_zeros_and_updates_bit_for_bit():
    from repro.optim import apply_updates as ref_apply
    from repro.utils import tree as rt
    from repro_torch.optim import apply_updates
    from repro_torch.utils import tree as pt
    a, b = _trees(1)
    assert _bits_equal(rt.tree_scale(_j(a), 0.37), pt.tree_scale(_t(a), 0.37))
    assert _bits_equal(rt.tree_zeros_like(_j(a)), pt.tree_zeros_like(_t(a)))
    assert _bits_equal(ref_apply(_j(a), _j(b)), apply_updates(_t(a), _t(b)))
    half = pt.tree_cast(_t(a), torch.float16)
    assert _bits_equal(rt.tree_cast(_j(a), jnp.float16), half)
    bf = pt.tree_cast(_t(a), torch.bfloat16)
    ref_bf = rt.tree_cast(_j(a), jnp.bfloat16)
    for x, y in zip(jax.tree.leaves(ref_bf), pt.tree_leaves(bf)):
        assert np.asarray(x).view(np.int16).tobytes() == y.view(
            torch.int16).numpy().tobytes()


def test_tree_dot_and_l2_to_fp32_rounding():
    from repro.utils import tree as rt
    from repro_torch.utils import tree as pt
    a, b = _trees(2)
    xs, ys = (np.concatenate([np.ravel(x) for x in jax.tree.leaves(t)])
              for t in (a, b))
    # fp32 sums in another order: within a few ulps of the terms' scale
    scale = float(np.abs(xs.astype(np.float64) * ys).sum())
    want = float(rt.tree_dot(_j(a), _j(b)))
    got = pt.tree_dot(_t(a), _t(b))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * scale
    want = float(rt.tree_l2(_j(a)))
    assert abs(float(pt.tree_l2(_t(a))) - want) <= 1e-6 * want


def test_tree_counts_paths_and_checks_equal_the_reference():
    from repro.models import cnn as ref_cnn
    from repro.utils import tree as rt
    from repro_torch.models import cnn
    from repro_torch.utils import tree as pt
    a, _ = _trees(3)
    ja, ta = _j(a), _t(a)
    assert pt.tree_bytes(ta) == rt.tree_bytes(ja)
    assert pt.count_params(ta) == rt.count_params(ja)
    assert cnn.count_params(ta) == ref_cnn.count_params(ja)
    for pattern in ("w$", "^conv", "blocks/1", "nothing"):
        assert (pt.tree_leaves(pt.select_by_path(ta, pattern))
                == jax.tree.leaves(rt.select_by_path(ja, pattern)))
    assert ([pt.path_str(p) for p, _ in pt.tree_leaves_with_path(ta)]
            == [rt.path_str(kp) for kp, _ in
                jax.tree_util.tree_leaves_with_path(ja)])
    assert pt.path_str(jax.tree_util.tree_leaves_with_path(ja)[0][0]) == \
        rt.path_str(jax.tree_util.tree_leaves_with_path(ja)[0][0])
    assert pt.check_finite(ta) == rt.check_finite(ja) is True
    a["fc"]["w"][2, 3] = np.nan
    a["blocks"][1][0] = np.inf
    ints = {"n": np.arange(4, dtype=np.int32)}
    for bad in ({"fc": a["fc"]}, {"b": a["blocks"]}, ints):
        assert pt.check_finite(_t(bad)) == rt.check_finite(_j(bad))


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_mask_density_and_packed_coords_equal_the_reference(density):
    from repro.core.masks import mask_density as ref_density
    from repro.sparse import pack_tree as ref_pack_tree
    from repro.sparse import tree_packed_coords as ref_coords
    from repro_torch.core.masks import mask_density
    from repro_torch.sparse import pack_tree, tree_packed_coords
    a, _ = _trees(4)
    rng = np.random.default_rng(5)
    m = jax.tree.map(lambda x: (rng.random(x.shape) < density
                                ).astype(np.float32), a)
    assert mask_density(_t(m)) == ref_density(_j(m))
    assert mask_density(_t(m), _t(a)) == ref_density(_j(m), _j(a))
    assert tree_packed_coords(pack_tree(_t(a), _t(m))) == ref_coords(
        ref_pack_tree(_j(a), _j(m)))


@pytest.mark.parametrize("u,k,n,bk,bn", [(1, 64, 96, 32, 32),
                                         (3, 128, 128, 128, 128),
                                         (2, 96, 64, 32, 16)])
def test_block_masks_equal_the_reference(u, k, n, bk, bn):
    from repro.kernels import masked_matmul as ref_mm
    from repro_torch.kernels import masked_matmul as mmk
    rng = np.random.default_rng(u * k + n)
    mask = (rng.random((u, k, n)) < 0.02).astype(np.float32)
    mask[0, :bk, :bn] = 0.0                  # one empty tile at least
    got = mmk.batched_block_mask(torch.from_numpy(mask), bk, bn)
    want = np.asarray(ref_mm.batched_block_mask(jnp.asarray(mask), bk, bn))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert got[0, 0, 0] == 0
    one = mmk.block_mask_from_mask(torch.from_numpy(mask[0]), bk, bn)
    assert np.array_equal(one.numpy(), np.asarray(
        ref_mm.block_mask_from_mask(jnp.asarray(mask[0]), bk, bn)))


def test_load_clients_reads_either_packages_directories(tmp_path):
    from repro.checkpoint import load_clients as ref_load
    from repro.checkpoint import save_clients as ref_save
    from repro_torch.checkpoint import load_clients, save_clients
    states = [{"params": a, "masks": jax.tree.map(np.sign, b)}
              for a, b in (_trees(6), _trees(7))]
    ref_save(str(tmp_path / "ref"), [_j(s) for s in states])
    save_clients(str(tmp_path / "port"), [_t(s) for s in states])
    for d in ("ref", "port"):
        got = load_clients(str(tmp_path / d), device="cpu")
        want = ref_load(str(tmp_path / d))
        assert len(got) == len(want) == 2
        for g, w, s in zip(got, want, states):
            assert _bits_equal(w, g) and _bits_equal(_j(s), g)


def _erk_check(ref_masks, port_masks, params, densities):
    """Shapes and dtypes equal; a non-sparsifiable leaf all ones; each
    sparsifiable leaf's nnz, in both packages, within six standard
    deviations of its Bernoulli(ERK density) count."""
    from repro_torch.utils.tree import tree_leaves_with_path
    ref = dict(zip((p for p, _ in tree_leaves_with_path(params)),
                   jax.tree.leaves(ref_masks)))
    for path, m in tree_leaves_with_path(port_masks):
        r = np.asarray(ref[path])
        assert tuple(m.shape) == r.shape and str(m.dtype)[6:] == str(r.dtype)
        if path not in densities:
            assert bool((m == 1).all()) and (r == 1).all()
            continue
        d, n = densities[path], m.numel()
        sd = max(np.sqrt(n * d * (1 - d)), 1.0)
        for nnz in (int((m != 0).sum()), int((r != 0).sum())):
            assert abs(nnz - d * n) <= 6 * sd, (path, nnz, d * n)


def test_init_client_masks_draws_erk_masks_as_the_reference():
    from repro.core.masks import erk_densities_for_params as ref_erk
    from repro.core.masks import init_client_masks as ref_init
    from repro_torch.core.masks import erk_densities_for_params
    from repro_torch.core.masks import init_client_masks
    a, _ = _trees(8)
    caps = [0.2, 0.5, 1.0]
    got = init_client_masks(torch.Generator().manual_seed(0), _t(a), caps)
    want = ref_init(jax.random.PRNGKey(0), _j(a), caps)
    assert len(got) == len(want) == 3
    for c, g, w in zip(caps, got, want):
        dens = erk_densities_for_params(_t(a), c)
        assert dens == ref_erk(_j(a), c)
        _erk_check(w, g, _t(a), dens)
    again = init_client_masks(torch.Generator().manual_seed(0), _t(a), caps,
                              dtype=torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 and torch.equal(x.float(), y)
               for m2, m1 in zip(again, got)
               for x, y in zip(pt_leaves(m2), pt_leaves(m1)))


def test_dispfl_state_is_the_state_a_dispfl_run_starts_from():
    from repro.fl.base import FLConfig as RefCfg
    from repro.fl.base import make_cnn_task as ref_task
    from repro.fl.dispfl import dispfl_state as ref_state
    from repro_torch.core.masks import erk_densities_for_params
    from repro_torch.data import build_federated_image_task
    from repro_torch.fl import FLConfig, make_cnn_task, make_strategy
    from repro_torch.fl.dispfl import dispfl_state
    kw = dict(n_clients=3, rounds=1, density=0.5, seed=4)
    cfg, rcfg = FLConfig(**kw), RefCfg(**kw)
    task = make_cnn_task("smallcnn", 10, 8, width=4, device="cpu")
    params, masks = dispfl_state(task, cfg)
    rparams, rmasks = ref_state(ref_task("smallcnn", 10, 8, width=4), rcfg)
    clients, _ = build_federated_image_task(
        0, n_clients=3, n_train_per_class=4, n_test_per_client=4, hw=8)
    state = make_strategy("dispfl").init_state(task, clients, cfg)
    for k in range(3):
        assert all(torch.equal(x, y) for x, y in zip(
            pt_leaves(params[k]), pt_leaves(state["params"][k])))
        assert all(torch.equal(x, y) for x, y in zip(
            pt_leaves(masks[k]), pt_leaves(state["masks"][k])))
        _erk_check(rmasks[k], masks[k], params[k],
                   erk_densities_for_params(params[k], cfg.client_density(k)))
        for w, m in zip(pt_leaves(params[k]), pt_leaves(masks[k])):
            assert bool((w[m == 0] == 0).all())
        assert [tuple(x.shape) for x in pt_leaves(params[k])] == [
            np.shape(x) for x in jax.tree.leaves(rparams[k])]


def test_split_like_gives_a_generator_per_leaf():
    from repro.utils.tree import split_like as ref_split
    from repro_torch.utils.tree import split_like, tree_leaves
    a, _ = _trees(9)
    gens = split_like(torch.Generator().manual_seed(3), _t(a))
    keys = ref_split(jax.random.PRNGKey(3), _j(a))
    assert len(tree_leaves(gens)) == len(jax.tree.leaves(keys)) == 5
    assert all(isinstance(g, torch.Generator) for g in tree_leaves(gens))
    draws = [float(torch.rand((), generator=g)) for g in tree_leaves(gens)]
    assert len(set(draws)) == 5
    again = split_like(torch.Generator().manual_seed(3), _t(a))
    assert draws == [float(torch.rand((), generator=g))
                     for g in tree_leaves(again)]
