"""Quickstart on the PyTorch port: DisPFL vs Local / D-PSGD(-FT) on a
non-IID synthetic task (``examples/quickstart.py`` through
``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Ten clients, pathological label split (2 classes each), 8 rounds, on the
CUDA GPU (``--device cpu`` runs the plain versions on the CPU; without a
GPU and without it, the task refuses to start).  Shows the paper's
headline effects: personalized accuracy above both local-only and
consensus-model training, at roughly half the busiest-node communication.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.data import build_federated_image_task  # noqa: E402
from repro_torch.fl import FLConfig, make_cnn_task, run_strategy  # noqa: E402

METHODS = ("local", "dpsgd", "dpsgd_ft", "dispfl")


def main(argv=None) -> dict:
    """Print one row per method; returns ``{method: FLResult}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--samples-per-class", type=int, default=80)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    clients, _ = build_federated_image_task(
        seed=0, n_clients=args.clients, partition="pathological",
        classes_per_client=2, n_train_per_class=args.samples_per_class,
        n_test_per_client=40, hw=16, noise=0.8)
    task = make_cnn_task("smallcnn", n_classes=10, hw=16, width=12,
                         device=args.device)
    cfg = FLConfig(n_clients=args.clients, rounds=args.rounds,
                   local_epochs=args.epochs, batch_size=32, degree=4,
                   density=0.5, eval_every=2)

    print(f"{'method':12s} {'acc':>7s} {'comm(MB)':>9s} {'GFLOP/round':>12s}")
    out = {}
    for method in METHODS:
        res = out[method] = run_strategy(method, task, clients, cfg)
        print(f"{method:12s} {res.final_acc:7.3f} "
              f"{res.comm_busiest_mb:9.2f} {res.flops_per_round/1e9:12.2f}")
    return out


if __name__ == "__main__":
    main()
