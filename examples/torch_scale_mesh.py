"""K=256 DisPFL clients per round on one card, on the PyTorch port
(``examples/scale_mesh.py`` through ``repro_torch``).

This is the ``repro_torch.scale`` regime: the whole communication round —
the intersection gossip (an adjacency-weighted masked einsum over the
stacked client dim), the masked local-SGD phase and the batched
prune/regrow mask search — runs over stacked client state, on the card as
one captured CUDA graph: 256 personalized sparse models train per round,
where the loop engine would launch per client.

The reference shards the client dim over a mesh of 8 host devices it forces
before jax starts.  By default the port holds all K clients on the one
card; ``--mesh-shape DxM`` shards them over a ``DeviceMesh`` of that
shape, one process per position, started by ``torchrun`` (rank 0
prints):

    PYTHONPATH=src python examples/torch_scale_mesh.py [--device cpu]
    PYTHONPATH=src torchrun --standalone --nproc_per_node 8 \
        examples/torch_scale_mesh.py --device cpu --mesh-shape 8x1
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.data import build_federated_image_task  # noqa: E402
from repro_torch.fl import FLConfig, make_cnn_task, make_strategy  # noqa: E402
from repro_torch.scale import ScaleEngine  # noqa: E402
from repro_torch.sparse import encoded_nbytes  # noqa: E402


def main(argv=None) -> dict:
    """Print each round's row and the per-message codec frame; returns
    ``{"engine": ScaleEngine, "frames": [bytes per client], "accs":
    [mean accuracy per evaluated round]}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--samples-per-class", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh-shape", default="",
                    help="DATAxMODEL: shard the clients over a DeviceMesh "
                         "(under torchrun, one process per position)")
    args = ap.parse_args(argv)

    k, rounds = args.clients, args.rounds
    # ~20 samples per client: 512 per class split over the ~51 clients
    # holding each class — tiny shards, but 256 of them, which is the point
    clients, _ = build_federated_image_task(
        0, n_clients=k, partition="pathological", classes_per_client=2,
        n_train_per_class=args.samples_per_class, n_test_per_client=10,
        hw=8, noise=0.8)
    task = make_cnn_task("smallcnn", n_classes=10, hw=8, width=8,
                         device=args.device)
    cfg = FLConfig(n_clients=k, rounds=rounds, local_epochs=args.epochs,
                   batch_size=8, degree=8, density=0.5, eval_every=rounds)
    mesh, say = None, print
    if args.mesh_shape:
        from repro_torch.launch.mesh import make_test_mesh

        data, model = (int(x) for x in args.mesh_shape.split("x"))
        mesh = make_test_mesh(data, model, device_type=args.device)
        if mesh.get_rank():
            say = lambda *a: None  # noqa: E731
        say(f"mesh {args.mesh_shape} -> {k} clients, {k // data} per "
            "client shard")
    else:
        say(f"one {task.device.type} device -> {k} clients, stacked")

    engine = ScaleEngine(make_strategy("dispfl"), task, clients, cfg,
                         mesh=mesh)
    accs = []
    for m in engine.rounds():
        if m.acc_mean is not None:
            accs.append(m.acc_mean)
        acc = f" acc={m.acc_mean:.3f}±{m.acc_std:.3f}" if m.acc_mean else ""
        say(f"round {m.round + 1}/{rounds}: busiest-node "
            f"{m.comm_busiest_mb:.2f} MB, lr={m.lr:.3f}, "
            f"wall {m.wall_s:.1f}s{acc}")

    frames = [encoded_nbytes(msg["packed"])
              for msg in engine.snapshot_messages()]
    say(f"per-message codec frame: mean {np.mean(frames) / 1e3:.1f} kB "
        f"(density {cfg.density}); {k} models mixed per round, one "
        f"graph replay")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return {"engine": engine, "frames": frames, "accs": accs}


if __name__ == "__main__":
    main()
