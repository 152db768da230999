"""The client-sharded ``ScaleEngine`` (``mesh=`` a ``DeviceMesh``) on the
CPU: four gloo ranks (``torch.multiprocessing`` spawn, a ``FileStore``),
dispfl K=8 at the reference tests' size, meshes 4x1 and 2x2, against the
port's unsharded engine and the reference's meshed run, all from one
initial archive.

Tolerances:
- ``ordered``: bit-equal to the unsharded run (state, archives, accuracy
  histories, comm rows): each receiver's gossip launch is the unsharded
  round's and the gather moves bits;
- ``einsum``: params within atol 1e-6 of the unsharded run (each rank's
  adjacency GEMM has M = K_local rows; on this CPU the measured gap is
  0), masks and accuracies equal;
- the reference's meshed run (``XLA_FLAGS=--xla_force_host_platform_
  device_count=4``, as ``tests/test_scale_engine.py`` runs it): accuracy
  histories within its own 1e-5, params within fp32 tolerance (1e-5, the
  criterion of ``test_torch_scale.py``), masks equal.
The world starts once for every case (``_torch_mesh_world.run_rank``); the
reference's subprocess and one ``torchrun --nproc_per_node 2`` CLI run go
on beside it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_world as world
from repro_torch.checkpoint.npz import load_pytree
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as port_train
from repro_torch.utils.tree import tree_leaves_with_path
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PARAM_ATOL = 1e-5
ACC_ATOL = 1e-5
EINSUM_ATOL = 1e-6
SHAPES = [f"{d}x{m}" for d, m in world.SHAPES]
ARGV = ["simulate", "--scale", "--scale-reduction", "ordered", "--rounds",
        "2", "--clients", "4", "--local-epochs", "1", "--samples-per-class",
        "8", "--hw", "8", "--width", "4", "--degree", "2", "--partition",
        "pathological", "--device", "cpu"]
TIMINGS = ("wall_s", "round_wall_s", "phase_s")

REF_CODE = """
import json, sys
from repro.data import build_federated_image_task
from repro.fl import FLConfig, make_cnn_task, make_strategy
from repro.launch.mesh import make_test_mesh
from repro.scale import ScaleEngine
data, cfg, start, end = json.loads(sys.argv[1])
clients = build_federated_image_task(0, **data)[0]
task = make_cnn_task("smallcnn", 10, 8, width=4)
eng = ScaleEngine(make_strategy("dispfl"), task, clients, FLConfig(**cfg),
                  mesh=make_test_mesh(data=2, model=2), reduction="einsum")
eng.restore(start)
res = eng.run()
eng.save(end)
print(json.dumps({"acc_history": res.acc_history,
                  "final_accs": res.final_accs}))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unsharded runs here, the reference's meshed run and a torchrun
    CLI run in subprocesses, and the spawned world, all at once."""
    d = str(tmp_path_factory.mktemp("mesh"))
    start, end_ref = os.path.join(d, "start.npz"), os.path.join(d, "ref.npz")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CODE,
         json.dumps([world.DATA, world.CFG, start, end_ref])],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train"]
        + ARGV + ["--mesh-shape", "2x1"],
        env=_env(OMP_NUM_THREADS="1"), cwd=d, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    out = {"dir": d, "plain": {}}
    try:
        for reduction in world.REDUCTIONS:
            eng = world.engine(reduction)
            if reduction == "ordered":
                eng.save(start)
                world.engine("ordered", n_clients=2).save(
                    os.path.join(d, "start2.npz"))
            rounds = eng.rounds()
            next(rounds)
            if reduction == "ordered":
                eng.save(os.path.join(d, "mid.npz"))
            for _ in rounds:
                pass
            eng.save(os.path.join(d, f"plain-{reduction}.npz"))
            out["plain"][reduction] = {"result": eng.result(),
                                       "comm": eng._comm}
        eng = world.engine("ordered", n_clients=2).restore(
            os.path.join(d, "start2.npz"))
        eng.run()
        eng.save(os.path.join(d, "plain2.npz"))
        mp.spawn(world.run_rank, args=(world.WORLD, d), nprocs=world.WORLD)
        out["ranks"] = [json.load(open(os.path.join(d, f"rank{r}.json")))
                        for r in range(world.WORLD)]
        out["cli_unsharded"] = port_train.main(
            [a for a in ARGV])
        ref_out, ref_err = ref.communicate(timeout=600)
        assert ref.returncode == 0, ref_err[-3000:]
        out["ref"] = json.loads(ref_out.strip().splitlines()[-1])
        cli_out, cli_err = cli.communicate(timeout=300)
        assert cli.returncode == 0, cli_err[-3000:]
        out["cli"] = cli_out
    finally:
        for p in (ref, cli):
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _leaves(path):
    return dict(tree_leaves_with_path(load_pytree(path)))


def _cmp(a, b, atol=0.0, state_only=False):
    """Leaf by leaf: masks and engine rows exact, params within ``atol``
    (0: the bytes equal)."""
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for p, x in la.items():
        if state_only and not p.startswith("state"):
            continue
        y = lb[p]
        if atol and "/params/" in p:
            np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=p)
        else:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), p


@pytest.mark.parametrize("shape", SHAPES)
def test_ordered_meshed_round_bit_equal_to_unsharded(runs, shape):
    d = runs["dir"]
    _cmp(os.path.join(d, f"{shape}-ordered.npz"),
         os.path.join(d, "plain-ordered.npz"))
    plain = runs["plain"]["ordered"]
    for r in runs["ranks"]:
        got = r[f"{shape}-ordered"]
        assert got["acc_history"] == plain["result"].acc_history
        assert got["final_accs"] == plain["result"].final_accs
        assert got["comm"] == plain["comm"]


@pytest.mark.parametrize("shape", SHAPES)
def test_einsum_meshed_round_within_fp32_of_unsharded(runs, shape):
    d = runs["dir"]
    _cmp(os.path.join(d, f"{shape}-einsum.npz"),
         os.path.join(d, "plain-einsum.npz"), atol=EINSUM_ATOL,
         state_only=True)
    plain = runs["plain"]["einsum"]["result"]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[f"{shape}-einsum"]["acc_history"],
                                   plain.acc_history, rtol=0, atol=ACC_ATOL)


@pytest.mark.parametrize("key", [f"{s}-{r}" for s in SHAPES
                                 for r in world.REDUCTIONS])
def test_meshed_runs_match_reference_meshed_run(runs, key):
    """The reference's einsum run on its 2x2 host mesh from the same
    archive: every port meshed run within its tolerances of it."""
    ref = runs["ref"]
    got = runs["ranks"][0][key]
    np.testing.assert_allclose(got["acc_history"], ref["acc_history"],
                               rtol=0, atol=ACC_ATOL)
    np.testing.assert_allclose(got["final_accs"], ref["final_accs"],
                               rtol=0, atol=ACC_ATOL)
    d = runs["dir"]
    _cmp(os.path.join(d, f"{key}.npz"), os.path.join(d, "ref.npz"),
         atol=PARAM_ATOL, state_only=True)


@pytest.mark.parametrize("shape", SHAPES)
def test_archives_cross_between_meshed_and_unsharded(runs, shape):
    """The unsharded run's round-1 archive resumed on the mesh finishes
    bit-equal to the unsharded run, and the meshed archive (rank 0's,
    gathered) is the unsharded engine's byte for byte (so it loads where
    that one loads: either package's engines)."""
    d = runs["dir"]
    _cmp(os.path.join(d, f"{shape}-resumed.npz"),
         os.path.join(d, "plain-ordered.npz"))
    eng = world.engine("ordered").restore(os.path.join(d, f"{shape}-ordered.npz"))
    want = world.engine("ordered").restore(os.path.join(d, "plain-ordered.npz"))
    for k in ("params", "masks"):
        for (p, x), (_, y) in zip(tree_leaves_with_path(eng.state[k]),
                                  tree_leaves_with_path(want.state[k])):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), p


@pytest.mark.parametrize("shape", SHAPES)
def test_rank_layout_gather_and_phases(runs, shape):
    """Clients pod-major over the client axes (model replicas hold the
    same clients), each round's gather bytes, the eager phases, DTensor's
    Shard(0) layout and ``constrain`` agreeing with the rank's clients,
    and the whole round (NCCL's captured form) passing the CPU capture
    check with its collective inside."""
    d_size, m_size = (int(x) for x in shape.split("x"))
    k_local = 8 // d_size
    for rank, r in enumerate(runs["ranks"]):
        got = r[f"{shape}-ordered"]
        k0 = (rank // m_size) * k_local
        assert (got["k0"], got["k1"]) == (k0, k0 + k_local)
        assert got["gather_bytes"] == [got["row_bytes"] * (8 - k_local)] * 2
        assert got["capture"] == "eager" and got["step_compiles"] == 0
        assert got["phases"] == sorted(["inputs", "gather", "mix", "local",
                                        "evolve", "eval"])
        assert r[f"{shape}-capturable"] == "ok"
        lay = r[f"{shape}-layout"]
        assert lay["dtensor_rows"] and lay["constrain_rows"]
        assert lay["constrain_placements"] == ["S(0)", "R"]


def test_pod_major_layout_and_trimmed_client_axes(runs):
    """On (pod=2, data=2, model=1) rank r holds clients 2r:2r+2, as DTensor
    splits ('pod','data') pod first; K=2 on 4x1 trims the client axes to
    none, so every rank holds both clients, gathers nothing and ends
    bit-equal to the unsharded run."""
    for rank, r in enumerate(runs["ranks"]):
        pods = r["pods"]
        assert (pods["k0"], pods["k1"]) == (2 * rank, 2 * rank + 2)
        assert pods["axes"] == ["pod", "data"]
        assert pods["dtensor_rows"] and pods["constrain_rows"]
        assert pods["constrain_placements"] == ["S(0)", "S(0)", "R"]
        t = r["trimmed"]
        assert (t["axes"], t["k0"], t["k1"], t["gather_bytes"]) == (
            [], 0, 2, [])
    d = runs["dir"]
    _cmp(os.path.join(d, "trimmed.npz"), os.path.join(d, "plain2.npz"))


def test_mesh_of_another_size_than_the_world_is_refused(runs, monkeypatch):
    for r in runs["ranks"]:
        got = r["refused"]
        assert "torchrun --nproc_per_node 2" in got["(2, 1)"]
        assert "this world has 4" in got["(1, 1)"]
        assert "torchrun --nproc_per_node 8" in got["(8, 1)"]
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        port_mesh.make_test_mesh(2, 1, device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        port_mesh.make_test_mesh(1, 1, device_type="tpu")
    import torch.distributed as dist
    assert not dist.is_initialized()       # refused before any world


def test_torchrun_cli_json_equals_unsharded(runs):
    """``torchrun --nproc_per_node 2 -m repro_torch.launch.train simulate
    --scale --mesh-shape 2x1 --device cpu``: rank 0 prints one JSON, equal
    to the unsharded run's apart from timings and its ``mesh`` row; rank 1
    prints nothing."""
    text = runs["cli"]
    assert text.count('"strategy"') == 1
    got = json.loads(text[text.index("\n{") + 1:])
    want = runs["cli_unsharded"]
    mesh = got.pop("mesh")
    assert mesh == {"shape": "2x1", "world": 2, "backend": "gloo",
                    "capture": "eager", "clients_per_rank": 2,
                    "gather_bytes": mesh["gather_bytes"]}
    assert len(mesh["gather_bytes"]) == 2 and min(mesh["gather_bytes"]) > 0
    for key in TIMINGS:
        got.pop(key)
        want = {k: v for k, v in want.items() if k != key}
    assert got == json.loads(json.dumps(want))


def test_collective_capture_follows_the_backend():
    """NCCL's collective is captured with the round, gloo's is not: the
    backend decides, nothing tries a capture and falls back."""
    from repro_torch.utils import graph
    assert graph.collective_capture("nccl") == "whole"
    assert graph.collective_capture("gloo") == "segments"
    step = graph.graphed(lambda x: x + 1, collectives=True)
    assert step.collectives and not graph.graphed(lambda x: x).collectives
    with pytest.raises(graph.CaptureError):
        with graph.check_capturable():
            torch.ones(2).tolist()


# ---------------------------------------------------------------------------
# on the card (``-m cuda``; skipped where torch.cuda.is_available() is False)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (and nvcc to build the kernels); "
                    "torch.cuda.is_available() is False here")
    from repro_torch.device import setup_device
    return setup_device("cuda")


@pytest.mark.cuda
def test_world_of_one_nccl_round_on_card(cuda_device, tmp_path):
    """A 1x1 mesh, one NCCL rank (in a process of its own: the world
    outlives a test), against the unsharded round from one archive: the
    round one graph with its gather inside, ``ordered`` bit-equal,
    ``einsum`` within fp32 rounding."""
    code = ("import sys, _torch_mesh_world as w; "
            "w.card_world_of_one(sys.argv[1])")
    r = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], capture_output=True,
        text=True, timeout=600,
        env=_env(PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                             os.path.dirname(__file__)])))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for reduction, got in out.items():
        assert (got["capture"], got["backend"], got["step_compiles"]) == (
            "whole", "nccl", 1)
        assert got["max_diff"] <= EINSUM_ATOL and got["acc_equal"]
    assert out["ordered"]["bit_equal"]


@pytest.mark.cuda
def test_gloo_ranks_sharing_the_card(cuda_device, tmp_path):
    """Four gloo ranks on the one card, meshes 4x1 and 2x2, ``ordered``:
    each mesh's final archive bit-equal to the unsharded K=8 run; the round
    two graphed segments around the gather."""
    d = str(tmp_path)
    eng = world.engine("ordered", device="cuda")
    eng.save(os.path.join(d, "start.npz"))
    plain = world.engine("ordered", device="cuda").restore(
        os.path.join(d, "start.npz"))
    plain.run()
    mp.spawn(world.run_card_rank, args=(world.WORLD, d), nprocs=world.WORLD)
    for name in (f"{s[0]}x{s[1]}" for s in world.SHAPES):
        got = world.engine("ordered", device="cuda").restore(
            os.path.join(d, f"card-{name}.npz"))
        assert world.bits_equal(plain.state, got.state), name
        for r in range(world.WORLD):
            rank = json.load(open(os.path.join(d, f"card-rank{r}.json")))
            assert (rank[name]["capture"], rank[name]["step_compiles"]) == (
                "segments", 1)
