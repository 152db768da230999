"""The LM steps over a ``DeviceMesh`` on the CPU (``launch.steps``'
``plan_for`` and ``lower_*``, ``launch.gossip_opt``'s sharded ring,
``utils.collectives``), and the client widths of the ``ScaleEngine``'s
vmapped calls.

``plan_for`` is held to the reference's field for field over every arch,
input shape and mesh (the production meshes and the 2x2(x2) test meshes,
as duck-typed fakes that both packages read).  One spawned world of four
gloo ranks (``_torch_mesh_steps_world.run_rank``, which imports no jax)
runs the rest, on a 2x2 mesh where ``plan_for`` gives the ``qwen3-8b``
smoke arch K=2 clients of 2 rows.

Tolerances:
- the meshed train step (``einsum``, ``ppermute``), prefill and decode
  against the unsharded step on the same inputs: ``max|meshed - plain| <=
  1e-5 * max(1, max|plain|)`` (``assert_close``'s criterion of the port's
  LM tests; on this CPU the measured gap is 0);
- the sharded ring: bit-equal to ``ppermute_gossip`` on the whole stack,
  its collective bytes exactly the boundary rows' (per hop h, min(h, n)
  of a rank's n rows each way, per leaf the weight's shard in its dtype
  and the int8 mask's), and no all-gather;
- the engine's vmapped calls: one client each, unsharded and on both
  meshes.
"""
import json
import os

import pytest
import torch.multiprocessing as mp

import _torch_mesh_steps_world as world

pytestmark = pytest.mark.tier1

REL_TOL = 1e-5


class FakeMesh:
    """What both packages' ``plan_for`` read of a mesh: ``axis_names`` and a
    ``shape`` dict."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


MESHES = {"pod16x16": FakeMesh(data=16, model=16),
          "pod2x16x16": FakeMesh(pod=2, data=16, model=16),
          "testpod16x16": FakeMesh(data=2, model=2),
          "testpod2x16x16": FakeMesh(pod=2, data=2, model=2)}


def _arch_names():
    from repro_torch.configs import ARCHS
    return list(ARCHS)


@pytest.mark.parametrize("arch", _arch_names())
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_plan_for_equals_the_reference(mesh, arch):
    import jax.numpy as jnp
    import torch

    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import INPUT_SHAPES as REF_SHAPES
    from repro.launch import steps as ref_steps
    from repro_torch.configs import ARCHS, INPUT_SHAPES
    from repro_torch.launch import steps

    m = MESHES[mesh]
    for name, shape in INPUT_SHAPES.items():
        ref = ref_steps.plan_for(REF_ARCHS[arch], REF_SHAPES[name], m)
        got = steps.plan_for(ARCHS[arch], shape, m)
        assert got.mesh is ref.mesh is m
        assert (got.arch.name, got.shape.name, got.shape.seq_len,
                got.shape.global_batch, got.shape.mode) == (
            ref.arch.name, ref.shape.name, ref.shape.seq_len,
            ref.shape.global_batch, ref.shape.mode)
        for f in ("n_clients", "per_client_batch", "fsdp2d", "seq_data",
                  "max_cache_len"):
            assert getattr(got, f) == getattr(ref, f), (name, f)
        assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_steps"))
    mp.spawn(world.run_rank, args=(world.WORLD, d), nprocs=world.WORLD)
    return [json.load(open(os.path.join(d, f"rank{r}.json")))
            for r in range(world.WORLD)]


STEPS = ["train-einsum", "train-ppermute", "prefill", "decode"]


@pytest.mark.parametrize("case", STEPS)
def test_meshed_step_within_fp32_of_unsharded(ranks, case):
    for r, rank in enumerate(ranks):
        got = rank["steps"][case]
        assert (got["n_clients"], got["per_client_batch"]) == (2, 2)
        assert got["max_abs"] <= REL_TOL * max(1.0, got["scale"]), (r, got)


def test_meshed_step_collectives(ranks):
    """The einsum step all-gathers (the K clients and the 'model'
    shards); the ring step's mix is collective-permutes, and its
    all-gathers are only the 'model' shards, fewer bytes than einsum's;
    prefill and decode gather the 'model' shards and the outputs."""
    for rank in ranks:
        s = rank["steps"]
        assert set(s["train-einsum"]["counts"]) == {"all-gather"}
        assert set(s["train-ppermute"]["counts"]) == {"all-gather",
                                                      "collective-permute"}
        assert (s["train-ppermute"]["bytes"]["all-gather"]
                < s["train-einsum"]["bytes"]["all-gather"])
        for mode in ("prefill", "decode"):
            assert set(s[mode]["counts"]) == {"all-gather"}


RINGS = ["2x2-k2-d2", "2x2-k4-d4-bf16", "4x1-k8-d4"]


@pytest.mark.parametrize("case", RINGS)
def test_sharded_ring_bit_equal_to_the_roll(ranks, case):
    for rank in ranks:
        assert rank["ring"][case]["bit_equal"], case


@pytest.mark.parametrize("case", RINGS)
def test_ring_moves_exactly_the_boundary_rows(ranks, case):
    for rank in ranks:
        ring = rank["ring"][case]
        assert ring["bytes"] == {"collective-permute":
                                 float(ring["boundary_bytes"])}
        assert "all-gather" not in ring["counts"]
    # 2x2: the leaves' rows are sharded over 'model' too, so each rank
    # sends its shard of a row, not the row
    assert any(p[1] != "R"
               for p in ranks[0]["ring"]["2x2-k2-d2"]["placements"])


@pytest.mark.parametrize("case", STEPS)
def test_meshed_step_returns_its_state_at_the_placements(ranks, case):
    """Train's params and serve's cache come back at the placements they
    went in at, 'model' and FSDP shards included (the step gathers them
    to compute whole clients and keeps its own chunk)."""
    for rank in ranks:
        got = rank["steps"][case]
        assert got["placements_out"] == got["placements_in"]
        assert any(p[1] != "R" for p in got["placements_in"]), case


def test_engine_calls_take_one_client_whatever_the_mesh(ranks):
    """ROADMAP C3: the unsharded K=8 engine and each rank of the 4x1 and
    2x2 meshes make the same vmapped calls, one client each, so no mesh
    changes a call that cuDNN sees."""
    from repro_torch.scale.engine import CLIENTS_PER_CALL

    assert CLIENTS_PER_CALL == 1
    plain = ranks[0]["widths"]["unsharded"]
    kinds = {k for k, _ in plain}
    assert kinds == {"local", "evolve", "eval"}
    for mesh, k_local in (("2x2", 4), ("4x1", 2)):
        for rank in ranks:
            calls = rank["widths"][mesh]
            assert {w for _, w in calls} == {w for _, w in plain} == {1}
            for kind in kinds:
                n = sum(1 for k, _ in calls if k == kind)
                assert n * 8 == k_local * sum(1 for k, _ in plain
                                              if k == kind), (mesh, kind)
