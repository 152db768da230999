"""The port's sharding rules (``repro_torch.sharding``) against the
reference's ``repro.sharding``, on the CPU, with no process group.

The spec functions are pure Python over a mesh's axis names and sizes, so
both packages take the reference tests' fake meshes (2x2, 2x2x2) and the
production shapes (16x16, 2x16x16).  Every leaf of every smoke arch's
stacked param, cache and batch trees (the port's ``meta`` trees, at K=8, 2
and 1, which trims the client axes differently) gets the same
``PartitionSpec`` entries from both, under every flag.  The entries are
compared as jax 0.9 reads them back, a 1-tuple of axes as the axis name
(the reference's own ``test_*_resolve_on_test_meshes`` still expect the
1-tuple).  Then the placements the ``tree_*_shardings`` functions give,
and ``use_mesh_rules`` / ``constrain`` / ``logical_sharding``.  DTensor
placements on a live ``DeviceMesh`` are checked in a gloo world by
``tests/test_torch_mesh_engine.py``.
"""
import threading

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.sharding import ctx as ref_ctx
from repro.sharding import rules as ref_rules
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import InputShape
from repro_torch.launch import steps
from repro_torch.launch.mesh import client_capacity
from repro_torch.models import bind
from repro_torch.sharding import ctx, rules
from repro_torch.sharding.rules import PartitionSpec
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1


class _FakeMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


MESHES = {"2x2": _FakeMesh((2, 2), ("data", "model")),
          "2x2x2": _FakeMesh((2, 2, 2), ("pod", "data", "model")),
          "16x16": _FakeMesh((16, 16), ("data", "model")),
          "2x16x16": _FakeMesh((2, 16, 16), ("pod", "data", "model"))}
CLIENTS = (8, 2, 1)


def _trees(name, k):
    """The port's stacked param, decode-cache and train/decode batch
    leaves of a smoke arch at K clients: (path, shape) lists."""
    cfg = SMOKE_ARCHS[name]
    api = bind(cfg)
    train = steps.ScalePlan(cfg, InputShape("t", 32, 2 * k, "train"), k, 2)
    decode = steps.ScalePlan(cfg, InputShape("d", 32, 2 * k, "decode"), k, 2)

    def leaves(tree):
        return [(p, tuple(x.shape)) for p, x in tree_leaves_with_path(tree)]

    return {"params": leaves(steps.abstract_params(api, train)),
            "cache": leaves(steps.abstract_cache(api, decode)),
            "batch": leaves(steps.input_specs(api, train))
            + leaves(steps.input_specs(api, decode))}


@pytest.mark.parametrize("name", sorted(SMOKE_ARCHS))
def test_specs_equal_reference_on_every_leaf(name):
    n = 0
    for k in CLIENTS:
        trees = _trees(name, k)
        for mesh in MESHES.values():
            for p, shape in trees["params"]:
                for fsdp2d in (False, True):
                    for stacked in (True, False):
                        s = shape if stacked else shape[1:]
                        want = ref_rules.param_spec(p, s, mesh, fsdp2d,
                                                    stacked)
                        got = rules.param_spec(p, s, mesh, fsdp2d, stacked)
                        assert tuple(got) == tuple(want), (p, s, fsdp2d)
                        n += 1
                want = ref_rules.stacked_spec(shape, mesh)
                assert tuple(rules.stacked_spec(shape, mesh)) == tuple(want)
            for p, shape in trees["cache"]:
                for seq_data in (False, True):
                    for fsdp2d in (False, True):
                        want = ref_rules.cache_spec(p, shape, mesh, seq_data,
                                                    True, fsdp2d)
                        got = rules.cache_spec(p, shape, mesh, seq_data, True,
                                               fsdp2d)
                        assert tuple(got) == tuple(want), (p, shape)
                        n += 1
            for p, shape in trees["batch"]:
                for fsdp2d in (False, True):
                    want = ref_rules.batch_spec(p, shape, mesh, fsdp2d)
                    got = rules.batch_spec(p, shape, mesh, fsdp2d)
                    assert tuple(got) == tuple(want), (p, shape)
                    n += 1
    assert n > 100


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec as P
    for parts in ((("data",), None), (("pod", "data"), "model"), ((), "x"),
                  (None,), ()):
        assert tuple(PartitionSpec(*parts)) == tuple(P(*parts))
    # what the reference's stale tests expect, and what jax 0.9 computes
    assert ref_rules.stacked_spec((8, 3), MESHES["2x2"])[0] == "data"
    assert rules.stacked_spec((8, 3), MESHES["2x2"])[0] == "data"
    assert rules.stacked_spec((8, 3), MESHES["2x2x2"])[0] == ("pod", "data")
    assert rules.stacked_spec((2, 3), MESHES["2x2x2"])[0] == "pod"
    assert rules.stacked_spec((1, 3), MESHES["2x2"])[0] is None
    assert repr(PartitionSpec("data", None)) == "PartitionSpec('data', None)"


def test_placements_of_specs():
    pods, flat = MESHES["2x2x2"], MESHES["2x2"]
    assert rules.placements(PartitionSpec(("pod", "data"), None, "model"),
                            pods) == (Shard(0), Shard(0), Shard(2))
    assert rules.placements(PartitionSpec("data", None), flat) == (
        Shard(0), Replicate())
    assert rules.placements(PartitionSpec(None, None), flat) == (
        Replicate(), Replicate())
    with pytest.raises(ValueError, match="order"):
        rules.placements(PartitionSpec(("data", "pod")), pods)
    with pytest.raises(ValueError, match="two tensor dims"):
        rules.placements(PartitionSpec("model", "model"), flat)


def _spec_of(placements, names, ndim):
    """The spec a placement tuple stands for (mesh axes per tensor dim)."""
    dims = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(PartitionSpec(*dims))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_tree_shardings_are_the_specs_placements(mesh_name):
    mesh = MESHES[mesh_name]
    names = mesh.axis_names
    cfg = SMOKE_ARCHS["qwen3-8b"]
    api = bind(cfg)
    for k in CLIENTS:
        plan = steps.ScalePlan(cfg, InputShape("d", 32, 2 * k, "decode"), k, 2)
        params = steps.abstract_params(api, plan)
        cache = steps.abstract_cache(api, plan)
        batch = steps.input_specs(api, plan)
        for fsdp2d in (False, True):
            got = dict(tree_leaves_with_path(rules.tree_param_shardings(
                params, mesh, fsdp2d), is_leaf=lambda x: isinstance(x, tuple)))
            for p, x in tree_leaves_with_path(params):
                want = ref_rules.param_spec(p, tuple(x.shape), mesh, fsdp2d)
                assert _spec_of(got[p], names, x.dim()) == tuple(want), p
            # context parallelism on 'data' is the K=1 plan's (a 'data'
            # client dim beside it names one axis twice, which jax refuses)
            seq_data = k == 1
            got = dict(tree_leaves_with_path(rules.tree_cache_shardings(
                cache, mesh, seq_data, fsdp2d=fsdp2d),
                is_leaf=lambda x: isinstance(x, tuple)))
            for p, x in tree_leaves_with_path(cache):
                want = ref_rules.cache_spec(p, tuple(x.shape), mesh, seq_data,
                                            True, fsdp2d)
                assert _spec_of(got[p], names, x.dim()) == tuple(want), p
        got = dict(tree_leaves_with_path(rules.tree_batch_shardings(
            batch, mesh), is_leaf=lambda x: isinstance(x, tuple)))
        for p, x in tree_leaves_with_path(batch):
            assert _spec_of(got[p], names, x.dim()) == tuple(
                ref_rules.batch_spec(p, tuple(x.shape), mesh)), p
        stacked = rules.tree_stacked_shardings(params, mesh)
        client = ref_rules._client_axes(mesh, False, k)
        for pl in tree_leaves(stacked, is_leaf=lambda x: isinstance(x, tuple)):
            assert pl == tuple(Shard(0) if client and n in client
                               else Replicate() for n in names)
    # a 0-d batch leaf is replicated everywhere
    assert rules.tree_batch_shardings({"t": torch.zeros(())}, mesh)["t"] == \
        (Replicate(),) * len(names)


def test_state_shardings_and_adjacency_spec():
    cfg = SMOKE_ARCHS["jamba-1.5-large-398b"]
    api = bind(cfg)
    plan = steps.ScalePlan(cfg, InputShape("t", 32, 4, "train"), 2, 2)
    mesh = MESHES["2x2x2"]
    assert steps.FSDP2D_ARCHS == ("jamba-1.5-large-398b",)
    # the smoke config's name is not the published arch's, so its 2-client
    # plan is not FSDP2D, as the reference's plan_for decides
    for fsdp2d, want_fsdp2d in ((None, False), (True, True)):
        spec, p_sh, m_sh = steps.state_shardings(api, plan, mesh, fsdp2d)
        assert p_sh is m_sh
        leaves = dict(tree_leaves_with_path(
            p_sh, is_leaf=lambda x: isinstance(x, tuple)))
        for p, x in tree_leaves_with_path(spec):
            assert x.device.type == "meta"
            want = ref_rules.param_spec(p, tuple(x.shape), mesh, want_fsdp2d)
            assert _spec_of(leaves[p], mesh.axis_names, x.dim()) == tuple(
                want), p
    adj = steps.adjacency_spec(plan)
    assert adj.shape == (2, 2) and adj.dtype == torch.float32
    assert adj.device.type == "meta"
    assert client_capacity(MESHES["2x2x2"]) == 4
    assert client_capacity(MESHES["16x16"]) == 16


def test_axis_rules_and_logical_specs_equal_reference():
    overrides = {"kv_seq": ("data",), "embed": ("model",)}
    names = [("client", "batch", "seq", "embed"), ("expert", None, "conv"),
             ("kv_seq", "heads", "unknown"), ("fsdp", "vocab")]
    for mesh in MESHES.values():
        for ov in (None, overrides):
            assert ctx.axis_rules(mesh, ov) == ref_ctx.axis_rules(mesh, ov)
            r = ctx.axis_rules(mesh, ov)
            for n in names:
                assert tuple(ctx._spec_for(n, r)) == tuple(
                    ref_ctx._spec_for(n, r))
                want = ref_ctx._spec_for(n, r)
                assert _spec_of(ctx.logical_sharding(mesh, n, ov),
                                mesh.axis_names, len(n)) == tuple(want)


def test_use_mesh_rules_and_constrain():
    x = torch.ones(2, 3)
    assert ctx.current_mesh() is None
    assert ctx.constrain(x, ("client", "embed")) is x   # no context: no-op
    outer, inner = MESHES["2x2"], MESHES["2x2x2"]
    seen = []
    with ctx.use_mesh_rules(outer):
        assert ctx.current_mesh() is outer
        with ctx.use_mesh_rules(inner, {"embed": ("model",)}):
            assert ctx.current_mesh() is inner
            assert ctx._rules()["embed"] == ("model",)
            # a plain tensor is this process's own data
            assert ctx.constrain(x, ("client", "embed")) is x
            with pytest.raises(ValueError, match="rank mismatch"):
                ctx.constrain(x, ("client",))
            t = threading.Thread(target=lambda: seen.append(
                ctx.current_mesh()))
            t.start()
            t.join()
        assert ctx.current_mesh() is outer
        assert ctx._rules()["embed"] == ()
    assert ctx.current_mesh() is None and ctx._rules() is None
    assert seen == [None]                  # the context is thread-local
    with pytest.raises(RuntimeError):
        with ctx.use_mesh_rules(outer):
            raise RuntimeError("boom")
    assert ctx.current_mesh() is None      # restored on an exception
