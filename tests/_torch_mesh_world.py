"""One rank of the gloo world ``test_torch_mesh_engine.py`` spawns on the
CPU (a module of its own, so a spawned rank imports torch and the port,
not jax).  ``run_rank`` runs every case and writes ``rank<r>.json``; rank
0 writes each meshed run's final archive."""
import json
import os

import torch
import torch.distributed as dist

DATA = dict(n_clients=8, partition="pathological", classes_per_client=2,
            n_train_per_class=24, n_test_per_client=16, hw=8, noise=0.7)
CFG = dict(n_clients=8, rounds=2, local_epochs=1, batch_size=16, degree=2,
           eval_every=1)
SHAPES = ((4, 1), (2, 2))
REDUCTIONS = ("ordered", "einsum")
WORLD = 4


def engine(reduction, mesh=None, n_clients=8, device="cpu"):
    """ScaleEngine dispfl at the reference tests' size (smallcnn width 4,
    hw 8), ``n_clients`` of the same split, on ``device``."""
    from repro_torch.data.loader import build_federated_image_task
    from repro_torch.fl.base import FLConfig, make_cnn_task
    from repro_torch.fl.engine import make_strategy
    from repro_torch.scale import ScaleEngine

    clients = build_federated_image_task(
        0, **{**DATA, "n_clients": n_clients})[0]
    task = make_cnn_task("smallcnn", 10, 8, width=4, device=device)
    return ScaleEngine(make_strategy("dispfl"), task, clients,
                       FLConfig(**{**CFG, "n_clients": n_clients}),
                       reduction=reduction, mesh=mesh)


def _layout_checks(mesh, shard):
    """DTensor's layout of a (K, 3) tensor on ``mesh`` against the
    engine's client shard, and ``constrain`` redistributing to it."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.sharding import constrain, use_mesh_rules
    from repro_torch.sharding.rules import stacked_sharding

    full = torch.arange(shard.k * 3, dtype=torch.float32).reshape(shard.k, 3)
    placed = distribute_tensor(full, mesh, stacked_sharding((shard.k, 3),
                                                            mesh))
    rows = full[shard.k0:shard.k1]
    repl = distribute_tensor(full, mesh, [Replicate()] * mesh.ndim)
    with use_mesh_rules(mesh):
        moved = constrain(repl, ("client", None))
    return {"dtensor_rows": torch.equal(placed.to_local(), rows),
            "constrain_rows": torch.equal(moved.to_local(), rows),
            "constrain_placements": [str(p) for p in moved.placements]}


def run_rank(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), world), rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.scale.engine import ClientShard
    from repro_torch.utils import graph
    from repro_torch.utils.tree import tree_leaves

    out = {}
    for shape in SHAPES:
        mesh = make_test_mesh(*shape, device_type="cpu")
        name = f"{shape[0]}x{shape[1]}"
        for reduction in REDUCTIONS:
            eng = engine(reduction, mesh).restore(os.path.join(d, "start.npz"))
            res = eng.run()
            eng.save(os.path.join(d, f"{name}-{reduction}.npz"))
            out[f"{name}-{reduction}"] = {
                "acc_history": res.acc_history, "final_accs": res.final_accs,
                "comm": eng._comm, "k0": eng.shard.k0, "k1": eng.shard.k1,
                "gather_bytes": eng.gather_bytes, "capture": eng.capture,
                "step_compiles": eng.step_compiles,
                "phases": sorted(eng.phase_s[0]),
                "row_bytes": sum(x[0].numel() * x.element_size() for x in
                                 tree_leaves(eng.state))}
        # an unsharded run's archive, resumed on the mesh
        eng = engine("ordered", mesh).restore(os.path.join(d, "mid.npz"))
        eng.run()
        eng.save(os.path.join(d, f"{name}-resumed.npz"))
        # the round as NCCL captures it whole, under the CPU capture check
        eng = engine("ordered", mesh)
        inp = eng._round_inputs(eng._make_ctx(0))
        _, step = eng._build_round_step()
        try:
            with graph.check_capturable():
                step.fn(eng.state, inp)
            out[f"{name}-capturable"] = "ok"
        except graph.CaptureError as e:
            out[f"{name}-capturable"] = str(e)
        out[f"{name}-layout"] = _layout_checks(mesh, eng.shard)
    pods = make_test_mesh(data=2, model=1, pods=2, device_type="cpu")
    shard = ClientShard(pods, 8)
    out["pods"] = {"k0": shard.k0, "k1": shard.k1, "axes": shard.axes,
                   **_layout_checks(pods, shard)}
    # K=2 on 4x1: ('data',) of 4 does not divide 2, so every rank holds all
    eng = engine("ordered", make_test_mesh(4, 1, device_type="cpu"),
                 n_clients=2)
    eng.restore(os.path.join(d, "start2.npz")).run()
    eng.save(os.path.join(d, "trimmed.npz"))
    out["trimmed"] = {"axes": eng.shard.axes, "k0": eng.shard.k0,
                      "k1": eng.shard.k1, "gather_bytes": eng.gather_bytes}
    refused = {}
    for shape in ((2, 1), (1, 1), (8, 1)):
        try:
            make_test_mesh(*shape, device_type="cpu")
            refused[str(shape)] = ""
        except ValueError as e:
            refused[str(shape)] = str(e)
    out["refused"] = refused
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def bits_equal(a, b) -> bool:
    """Two stacked states bit for bit (float32 leaves as int32)."""
    from repro_torch.utils.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32).to(x.device))
        for x, y in zip(la, lb))


def card_world_of_one(d):
    """On the card: the unsharded round and the round on a 1x1 mesh (a
    world of one NCCL rank, started in process) from one archive, per
    reduction; prints one JSON line."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.utils.tree import tree_leaves

    out = {}
    mesh = make_test_mesh(1, 1, device_type="cuda")
    for reduction in REDUCTIONS:
        plain = engine(reduction, device="cuda")
        start = os.path.join(d, f"start-{reduction}.npz")
        plain.save(start)
        plain.run()
        meshed = engine(reduction, mesh, device="cuda").restore(start)
        meshed.run()
        out[reduction] = {
            "bit_equal": bits_equal(plain.state, meshed.state),
            "max_diff": max(float((x - y).abs().max()) for x, y in zip(
                tree_leaves(plain.state), tree_leaves(meshed.state))),
            "capture": meshed.capture, "backend": meshed.shard.backend,
            "step_compiles": meshed.step_compiles,
            "acc_equal": plain._acc_history == meshed._acc_history}
    dist.destroy_process_group()
    print(json.dumps(out))


def run_card_rank(rank, world, d):
    """One of four gloo ranks sharing the card: each of ``SHAPES``,
    ``ordered``, from ``start.npz``; rank 0 writes ``card-<shape>.npz``
    and every rank ``card-rank<r>.json``."""
    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), world), rank=rank, world_size=world)
    out = {}
    for shape in SHAPES:
        mesh = make_test_mesh(*shape, device_type="cuda", backend="gloo")
        name = f"{shape[0]}x{shape[1]}"
        eng = engine("ordered", mesh, device="cuda").restore(
            os.path.join(d, "start.npz"))
        eng.run()
        eng.save(os.path.join(d, f"card-{name}.npz"))
        out[name] = {"capture": eng.capture,
                     "step_compiles": eng.step_compiles,
                     "k_local": eng.shard.k_local,
                     "acc_history": eng._acc_history}
    with open(os.path.join(d, f"card-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
