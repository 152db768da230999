"""The port's dry run on the reference's meshes (``python -m
repro_torch.launch.dryrun --smoke --multi-pod`` and ``run_one`` on the
single-pod mesh), on a fake world of 4 or 8 ranks, in one subprocess: a fake process group is
process-wide, and the other tests of a pytest worker hold that no world
is up.  The reference's three assertions (``tests/test_dryrun_integration.py``)
on the port's records, and the ring gossip traced alone: its bytes a rank
exactly the boundary rows' weight and int8-mask bytes, no all-gather.
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
print(json.dumps({"bytes": stats.bytes_by_kind,
                  "counts": stats.count_by_kind, "boundary": boundary,
                  "k": plan.n_clients, "n": n}))
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
    # each rank computes whole clients: not comparable to the reference's
    # tensor-parallel records of the same mesh
    assert rec["tp"] is False


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
    ring = dry[1]
    assert (ring["k"], ring["n"]) == (2, 1)
    assert ring["bytes"] == {"collective-permute": float(ring["boundary"])}
    assert "all-gather" not in ring["counts"]
