"""The LM steps over a ``DeviceMesh`` on the CPU (``launch.steps``'
``plan_for`` and ``lower_*``, ``launch.gossip_opt``'s sharded ring,
``utils.collectives``), and the client widths of the ``ScaleEngine``'s
vmapped calls.

``plan_for`` is held to the reference's field for field over every arch,
input shape and mesh (the production meshes and the 2x2(x2) test meshes,
as duck-typed fakes that both packages read).  One spawned world of four
gloo ranks (``_torch_mesh_steps_world.run_rank``, which imports no jax)
runs the rest: ``sharding.tp``'s ops, and the meshed steps split over
'model' on a 2x2 mesh (``plan_for`` gives the ``qwen3-8b``,
``deepseek-moe-16b`` and ``mamba2-1.3b`` smoke archs K=2 clients of 2
rows; the jamba smoke arch takes the FSDP2D plan, one client of 4 rows,
weights 2-D sharded, its rows split over 'data') and a 1x4 mesh (K=1 of
4 rows, 'model' of 4: the qwen3 smoke arch's k/v columns cut a kv head),
each serve step on a random cache at its placements; and the long-context
decode of one row (``seq_data``) of the gemma3-1b and jamba smoke archs at
2x2, the cache's sequence in two chunks over 'data', at a position in
each chunk (gemma3's window crossing the chunk edge at one).

Tolerances:
- ``sharding.tp``'s ops (the all-to-all and the FSDP gather whose
  gradient is reduce-scattered over 'data' among them) under
  ``vmap(grad)`` and ``grad(vmap)`` against the one-process function:
  value and gradients within ``1e-5 * max(1, max|ref|)`` (measured
  ~2e-7);
- the meshed train step (``einsum``, ``ppermute``), prefill and decode
  (the ``seq_data`` decodes too) against the unsharded step on the same
  inputs: ``max|meshed - plain| <= 1e-5 * max(1, max|plain|)`` (``assert_close``'s criterion of the port's
  LM tests; measured up to 3.5e-6 of scale here, the all-reduced partial
  sums' order);
- the sharded ring: bit-equal to ``ppermute_gossip`` on the whole stack,
  its collective bytes exactly the boundary rows' (per hop h, min(h, n)
  of a rank's n rows each way, per leaf the weight's shard in its dtype
  and the int8 mask's), and no all-gather;
- the engine's vmapped calls: one client each, unsharded and on both
  meshes;
- the train step under ``remat="full"`` (the qwen3 smoke arch's K=2 plan
  and jamba's FSDP2D plan at 2x2): bit-equal to its ``remat=False``
  twin, its recompute issuing the blocks' collectives again.
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
#: every (mesh, arch, step) the world runs; the qwen3 smoke arch's steps
#: at 2x2 are ``STEPS``' cases
CASES = [f"{mesh}/{arch}/{step}" for mesh, archs in world.MESH_ARCHS.items()
         for arch in archs for step in STEPS]
TP_CASES = [c for c in CASES if not c.startswith(f"2x2/{world.ARCH}/")]
#: (n_clients, per_client_batch) of each mesh's plans
PLANS = {"2x2": (2, 2), "1x4": (1, 4)}


def _step(rank, case):
    return rank["steps"][case if "/" in case else f"2x2/{world.ARCH}/{case}"]


def _within_fp32(ranks, case):
    mesh, arch = (case.split("/")[:2] if "/" in case else ("2x2",
                                                          world.ARCH))
    want = (1, world.GLOBAL_BATCH) if arch in world.FSDP2D else PLANS[mesh]
    for r, rank in enumerate(ranks):
        got = _step(rank, case)
        assert (got["n_clients"], got["per_client_batch"]) == want
        assert got["max_abs"] <= REL_TOL * max(1.0, got["scale"]), (r, got)


@pytest.mark.parametrize("case", STEPS)
def test_meshed_step_within_fp32_of_unsharded(ranks, case):
    _within_fp32(ranks, case)


@pytest.mark.parametrize("case", TP_CASES)
def test_tp_step_within_fp32_of_unsharded(ranks, case):
    """The steps split over 'model' (and the jamba plan's FSDP over
    'data') on the other archs and on the 1x4 mesh."""
    _within_fp32(ranks, case)


@pytest.mark.parametrize("mesh", sorted(world.MESHES))
def test_tp_ops_match_one_process(ranks, mesh):
    """``copy_to``, ``reduce_from``, ``gather_from``, ``split_to`` and
    ``whole`` (an FSDP weight's gather) in one function, its value and each gradient (this
    rank's slice) under ``vmap(grad)``, ``grad(vmap)`` and a ``backward()``
    run outside the mesh context (where the GPU's autograd thread runs
    it), against the one-process function on the whole weights ('model'
    of 2 and of 4 ranks)."""
    for rank in ranks:
        got = rank["tp"][mesh]
        assert len(got) == 10
        for name, gap in got.items():
            assert gap <= REL_TOL, (mesh, name, gap)


def test_meshed_step_collectives(ranks):
    """The einsum step all-gathers (the K clients' shards over the client
    axes, and activations over 'model') and all-reduces the row-split
    matmuls' partial sums over 'model'; the ring step's mix is
    collective-permutes, and its all-gathers (activations over 'model'
    only) are fewer bytes than einsum's; prefill and decode all-to-all
    the new k/v (and the decode its q and output) between a split core's
    heads and the cache's head_dim shards, and all-reduce over 'model'
    (the decode's partial scores among them)."""
    from repro_torch.configs import SMOKE_ARCHS

    layers = SMOKE_ARCHS[world.ARCH].n_layers
    for rank in ranks:
        s = {c: _step(rank, c) for c in STEPS}
        assert set(s["train-einsum"]["counts"]) == {"all-gather",
                                                    "all-reduce"}
        assert set(s["train-ppermute"]["counts"]) == {
            "all-gather", "all-reduce", "collective-permute"}
        assert (s["train-ppermute"]["bytes"]["all-gather"]
                < s["train-einsum"]["bytes"]["all-gather"])
        for mode in ("prefill", "decode"):
            assert set(s[mode]["counts"]) == {"all-gather", "all-reduce",
                                              "all-to-all"}
            # a layer's k and v, and the decode's q and output
            assert s[mode]["axis_counts"]["all-to-all/model"] == (
                2 if mode == "prefill" else 4) * layers


@pytest.mark.parametrize("case", CASES)
def test_no_whole_model_sharded_weight_is_gathered(ranks, case):
    """No all-gather over 'model' carries a whole 'model'-sharded weight
    leaf of the rank's clients (its shape and its values' sum), and each
    step all-reduces over 'model'."""
    for rank in ranks:
        got = _step(rank, case)
        assert got["whole_weight_gathers"] == [], got
        assert got["model_counts"].get("all-reduce", 0) > 0, got


#: the names an earlier tree's steps recorded for the inputs they
#: gathered whole
WHOLE_INPUTS = ("serve cache", "fsdp2d batch")


@pytest.mark.parametrize("case", CASES)
def test_no_input_is_gathered_whole(ranks, case):
    """No step gathers an input whole where the reference splits it: none
    records one (the dry run's ``replicated`` field names only the ops
    the models leave replicated), and no all-gather sends a shard of a
    cache leaf or of a batch leaf."""
    for rank in ranks:
        got = _step(rank, case)
        assert not set(got["replicated"]) & set(WHOLE_INPUTS), (case, got)
        assert got["input_gathers"] == [], (case, got["input_gathers"])


SEQ_CASES = [f"2x2/{arch}/seq_data-pos{pos}" for arch in world.SEQ_DATA_ARCHS
             for pos in world.SEQ_DATA_POS]
#: the serve steps and the FSDP2D plan's steps: their cache or their rows
#: split over the mesh
INPUT_CASES = [c for c in CASES if c.split("/")[2] in ("prefill", "decode")
               or c.split("/")[1] in world.FSDP2D] + SEQ_CASES


@pytest.mark.parametrize("case", SEQ_CASES)
def test_seq_data_decode_within_fp32_of_unsharded(ranks, case):
    """Long-context decode, one client of one row: the cache's sequence
    split over 'data' in two chunks, each rank's partial softmax combined
    flash-decoding style, the window masked by global position and the
    new token written by the rank whose chunk holds it; within fp32 of
    the unsharded step, the cache back at its placements (its sequence
    over 'data')."""
    for r, rank in enumerate(ranks):
        got = _step(rank, case)
        assert (got["n_clients"], got["per_client_batch"]) == (1, 1)
        assert got["max_abs"] <= REL_TOL * max(1.0, got["scale"]), (r, got)
        assert got["placements_out"] == got["placements_in"]
        assert any(p[0].startswith("S(") for p in got["placements_in"]), got
        assert got["axis_counts"].get("all-reduce/data", 0) > 0, got


@pytest.mark.parametrize("case", INPUT_CASES)
def test_no_cache_or_batch_shard_is_all_gathered(ranks, case):
    """No all-gather, over any axis, sends this rank's shard of a cache
    leaf or of a batch leaf split over 'data' (their shapes, any dim
    leading, and their values' sums: the cache is random)."""
    for rank in ranks:
        assert _step(rank, case)["input_gathers"] == [], case


FSDP2D_TRAIN = [c for c in CASES if c.split("/")[1] in world.FSDP2D
                and c.split("/")[2].startswith("train")]


@pytest.mark.parametrize("case", FSDP2D_TRAIN)
def test_fsdp2d_train_reduce_scatters_over_data(ranks, case):
    """The FSDP2D plan's rows split over 'data': the FSDP weights' gathers
    reduce-scatter their gradients over 'data', and the loss's sum is
    all-reduced there."""
    for rank in ranks:
        got = _step(rank, case)["axis_counts"]
        assert got.get("reduce-scatter/data", 0) > 0, got
        assert got.get("all-reduce/data", 0) > 0, got


@pytest.mark.parametrize("mesh", sorted(world.MESHES))
def test_tp_rows_ops_match_one_process(ranks, mesh):
    """``all_to_all`` over 'model' and ``whole``'s FSDP gather with its
    gradient reduce-scattered over 'data' (the rows split over 'data'),
    its value and each gradient under ``vmap(grad)``, ``grad(vmap)`` and
    a ``backward()`` outside the mesh context, against the one-process
    function."""
    for rank in ranks:
        got = rank["tp_rows"][mesh]
        assert len(got) == 10
        for name, gap in got.items():
            assert gap <= REL_TOL, (mesh, name, gap)


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


def _state_at_placements(ranks, case):
    for rank in ranks:
        got = _step(rank, case)
        assert got["placements_out"] == got["placements_in"]
        assert any(p[-1] != "R" for p in got["placements_in"]), case


@pytest.mark.parametrize("case", STEPS)
def test_meshed_step_returns_its_state_at_the_placements(ranks, case):
    """Train's params and serve's cache come back at the placements they
    went in at, 'model' and FSDP shards included (train updates its
    shards; serve writes its shard of the cache)."""
    _state_at_placements(ranks, case)


@pytest.mark.parametrize("case", TP_CASES)
def test_tp_step_returns_its_state_at_the_placements(ranks, case):
    _state_at_placements(ranks, case)


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


@pytest.mark.parametrize("arch", world.REMAT_ARCHS)
def test_remat_full_train_step_bit_equal_to_none(ranks, arch):
    """The meshed train step bound with ``remat="full"`` returns the same
    bits as its ``remat=False`` twin on every rank, and its recompute
    issues the blocks' collectives again: every kind and axis at least as
    often, the 'model' all-reduces more often."""
    for r, rank in enumerate(ranks):
        got = rank["remat"][arch]
        assert got["bit_equal"] and got["n_leaves"] > 2, (r, got)
        full, none = got["axis_counts_full"], got["axis_counts_none"]
        assert set(full) == set(none), (r, got)
        assert all(full[k] >= none[k] for k in none), (r, got)
        assert full["all-reduce/model"] > none["all-reduce/model"], (r, got)


def test_remat_recompute_runs_under_the_forwards_mesh(ranks):
    """``sharding.tp`` ops inside a checkpointed block, ``backward()``
    called outside the mesh context: each policy's gradients bit-equal to
    the block's without rematerialisation, on every rank."""
    for r, rank in enumerate(ranks):
        assert rank["remat_tp"] == {"full": True, "dots": True}, r
