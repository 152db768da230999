"""The port's dry run on the reference's meshes (``python -m
repro_torch.launch.dryrun --smoke --multi-pod`` and ``run_one`` on the
single-pod mesh), on a fake world of 4 or 8 ranks, in one subprocess: a fake process group is
process-wide, and the other tests of a pytest worker hold that no world
is up.  The reference's three assertions (``tests/test_dryrun_integration.py``)
on the port's records (split over 'model': ``"tp": true``, no op left
replicated at these shapes, no input gathered whole), the ring gossip
traced alone: its bytes a rank exactly the boundary rows' weight and
int8-mask bytes, no all-gather; the qwen3-8b smoke arch's train step
traced on a fake 2x2 and a fake 2x1 world (K=2, one client a rank; at 2x2
every head splits whole): rank 0's FLOPs at 2x2 at most 1.25/2 of those
at 2x1; the jamba smoke arch's FSDP2D train step (one client, its rows
split over 'data' at 2x2) on a fake 2x2 and a fake 1x2 world: rank 0's
FLOPs at 2x2 at most 1.25/2 of those at 1x2; and the smoke decode steps'
all-gather bytes a rank below the bytes of the rank's cache shard (the
cache is read where it lies).
"""
import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.tier1

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SINGLE_POD = [("qwen3-8b", "train_4k"), ("deepseek-moe-16b", "train_4k"),
              ("mamba2-1.3b", "decode_32k")]

CODE = """
import json, sys
import torch
from repro_torch.launch import dryrun, steps
from repro_torch.launch.gossip_opt import ppermute_gossip
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.configs import SMOKE_ARCHS, INPUT_SHAPES
from repro_torch.utils.collectives import collective_bytes
from repro_torch.utils.tree import tree_leaves
from torch._subclasses.fake_tensor import FakeTensorMode
out, cases = sys.argv[1], json.loads(sys.argv[2])
for arch, shape, mesh, gossip in cases:
    if mesh == "pod2x16x16":
        dryrun.main(["--smoke", "--device", "cpu", "--arch", arch,
                     "--shape", shape, "--multi-pod", "--gossip", gossip,
                     "--out", out])
    else:
        dryrun.run_one(arch, shape, gossip=gossip, out_dir=out, smoke=True,
                       device="cpu", multi_pod=False)
# the ring alone, on gemma3-1b's smoke plan on the 2x2 test mesh
mesh = make_test_mesh(2, 2, device_type="cpu", backend="fake")
shape = INPUT_SHAPES["train_4k"]
plan, step = steps.lower_for(SMOKE_ARCHS["gemma3-1b"], shape, mesh,
                             "ppermute")
with FakeTensorMode():
    params, masks = step.abstract_args("cpu")[:2]
    _, stats = collective_bytes(ppermute_gossip, params, masks, plan)
n = tree_leaves(params)[0].to_local().shape[0]
boundary = sum(2 * min(1, n) * (w.to_local()[0].numel() * w.element_size()
                                + m.to_local()[0].numel())
               for w, m in zip(tree_leaves(params), tree_leaves(masks)))
ring = {"bytes": stats.bytes_by_kind, "counts": stats.count_by_kind,
        "boundary": boundary, "k": plan.n_clients, "n": n}
# the qwen3-8b smoke train step on a fake 2x2 and a fake 2x1 world
import dataclasses
from repro_torch.sharding.tp import record_replicated
from repro_torch.utils.trace_cost import step_cost
flops = {}
shape = dataclasses.replace(shape, seq_len=64, global_batch=2)
for data, model in ((2, 2), (2, 1)):
    mesh = make_test_mesh(data, model, device_type="cpu", backend="fake")
    plan, step = steps.lower_for(SMOKE_ARCHS["qwen3-8b"], shape, mesh)
    with FakeTensorMode(), record_replicated() as rep:
        args = step.abstract_args("cpu")
        _, cost = step_cost(step, *args)
    flops[f"{data}x{model}"] = {"flops": cost.flops, "k": plan.n_clients,
                                "rows": plan.per_client_batch,
                                "local_k": tree_leaves(args[0])[0]
                                .to_local().shape[0],
                                "replicated": sorted(rep)}
# the jamba smoke FSDP2D train step on a fake 2x2 and a fake 1x2 world,
# planned as plan_for plans the published arch (one client, 2-D weights)
from repro_torch.models import bind
jamba = {}
cfg = SMOKE_ARCHS["jamba-1.5-large-398b"]
shape = dataclasses.replace(shape, global_batch=8)
for data, model in ((2, 2), (1, 2)):
    mesh = make_test_mesh(data, model, device_type="cpu", backend="fake")
    plan = dataclasses.replace(steps.plan_for(cfg, shape, mesh), n_clients=1,
                               per_client_batch=8, fsdp2d=True)
    step = steps.lower_train(bind(cfg), plan)
    with FakeTensorMode():
        _, cost = step_cost(step, *step.abstract_args("cpu"))
    jamba[f"{data}x{model}"] = {"flops": cost.flops, "k": plan.n_clients,
                                "rows": plan.per_client_batch,
                                "fsdp2d": plan.fsdp2d}
# the smoke decode steps on the fake 2x2 world: all-gather bytes a rank
# against the bytes of the rank's cache shard
decode = {}
mesh = make_test_mesh(2, 2, device_type="cpu", backend="fake")
shape = dataclasses.replace(INPUT_SHAPES["decode_32k"], seq_len=64,
                            global_batch=8)
for arch in ("qwen3-8b", "mamba2-1.3b", "gemma3-1b"):
    plan, step = steps.lower_for(SMOKE_ARCHS[arch], shape, mesh)
    with FakeTensorMode():
        args = step.abstract_args("cpu")
        _, stats = collective_bytes(step, *args)
    decode[arch] = {"all_gather": stats.bytes_by_kind.get("all-gather", 0.0),
                    "cache": sum(x.to_local().numel()
                                 * x.to_local().element_size()
                                 for x in tree_leaves(args[2]))}
print(json.dumps({"ring": ring, "flops": flops, "jamba": jamba,
                  "decode": decode}))
"""


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_mesh"))
    cases = ([(a, s, "pod16x16", "einsum") for a, s in SINGLE_POD]
             + [("gemma3-1b", "train_4k", "pod2x16x16", "einsum"),
                ("gemma3-1b", "train_4k", "pod16x16", "ppermute")])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", CODE, out, json.dumps(cases)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]

    def rec(arch, shape, mesh, gossip="einsum"):
        tag = f"{arch}__{shape}__test{mesh}" + (
            f"__{gossip}" if gossip != "einsum" else "")
        with open(os.path.join(out, tag + ".json")) as f:
            return json.load(f)

    return rec, json.loads(r.stdout.strip().splitlines()[-1])


def test_smoke_dryrun_tp_records_split_every_op(dry):
    """The meshed records say ``"tp": true`` and, at the smoke archs'
    widths on 'model' of 2, name no op left replicated, the decode record
    too: its cache is read at its placements, not gathered whole."""
    for arch, shape in SINGLE_POD:
        rec = dry[0](arch, shape, "pod16x16")
        assert (rec["tp"], rec["replicated"]) == (True, []), rec["tag"]
    rec = dry[0]("gemma3-1b", "train_4k", "pod2x16x16")
    assert (rec["tp"], rec["replicated"]) == (True, [])


def test_tp_divides_rank_flops_over_model(dry):
    """qwen3-8b smoke train step, one client a rank: rank 0's FLOPs on a
    fake 2x2 world (its 4 q and 2 kv heads split whole over 'model' of
    2) at most 1.25/2 of those on a fake 2x1 world."""
    flops = dry[1]["flops"]
    for mesh in ("2x2", "2x1"):
        got = flops[mesh]
        assert (got["k"], got["local_k"], got["rows"], got["replicated"]) \
            == (2, 1, 1, []), (mesh, got)
    assert flops["2x2"]["flops"] <= 0.625 * flops["2x1"]["flops"], flops


def test_fsdp2d_rows_divide_rank_flops_over_data(dry):
    """The jamba smoke arch's FSDP2D train step, one client of 8 rows:
    split over 'data' at 2x2 (4 rows a rank; the MoE's routing runs on
    every row, its experts on the rank's capacity slots), rank 0's FLOPs
    at most 1.25/2 of those on a fake 1x2 world (every row a rank)."""
    jamba = dry[1]["jamba"]
    for mesh in ("2x2", "1x2"):
        got = jamba[mesh]
        assert (got["k"], got["rows"], got["fsdp2d"]) == (1, 8, True), got
    assert jamba["2x2"]["flops"] <= 0.625 * jamba["1x2"]["flops"], jamba


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-1.3b", "gemma3-1b"])
def test_smoke_decode_gathers_less_than_its_cache(dry, arch):
    """A smoke decode step on the fake 2x2 world all-gathers fewer bytes a
    rank than the rank's shard of the cache holds: the cache is read
    where it lies (a step that gathered it whole over 'model' would send
    at least that shard and receive the rest)."""
    got = dry[1]["decode"][arch]
    assert 0 < got["all_gather"] < got["cache"], got


@pytest.mark.parametrize("arch,shape", SINGLE_POD)
def test_smoke_dryrun_single_pod(dry, arch, shape):
    rec = dry[0](arch, shape, "pod16x16")
    assert rec["status"] == "ok", rec
    assert rec["cost"]["flops"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    # the reference's record fields
    assert rec["chips"] == 4 and rec["mesh"] == "testpod16x16"
    for key in ("n_clients", "per_client_batch", "fsdp2d", "seq_data",
                "collectives", "coll_bytes_per_device",
                "analytic_state_bytes_per_device"):
        assert key in rec, key
    assert (rec["n_clients"], rec["per_client_batch"]) == (2, 4)
    # each rank splits its clients over 'model', as the reference's
    # tensor-parallel records of the same mesh do
    assert rec["tp"] is True


def test_smoke_dryrun_multi_pod_has_cross_pod_collectives(dry):
    rec = dry[0]("gemma3-1b", "train_4k", "pod2x16x16")
    assert rec["status"] == "ok", rec
    assert rec["coll_bytes_per_device"] > 0
    kinds = rec["collectives"]["counts"]
    assert any(k in kinds for k in
               ("all-gather", "all-reduce", "collective-permute",
                "all-to-all"))
    assert (rec["chips"], rec["n_clients"]) == (8, 4)
    assert rec["roofline"]["collective_ms"] > 0


def test_smoke_dryrun_ring_gossip_uses_permute(dry):
    rec = dry[0]("gemma3-1b", "train_4k", "pod16x16", "ppermute")
    assert rec["status"] == "ok", rec
    assert rec["collectives"]["counts"].get("collective-permute", 0) > 0


def test_traced_ring_moves_exactly_the_boundary_rows(dry):
    ring = dry[1]["ring"]
    assert (ring["k"], ring["n"]) == (2, 1)
    assert ring["bytes"] == {"collective-permute": float(ring["boundary"])}
    assert "all-gather" not in ring["counts"]
