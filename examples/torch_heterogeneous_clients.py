"""Client heterogeneity on the PyTorch port (paper §4.3, Table 3 / Fig 4):
five capacity groups {20%, 40%, 60%, 80%, 100%} federate together; every
group still learns (``examples/heterogeneous_clients.py`` through
``repro_torch``).

    PYTHONPATH=src python examples/torch_heterogeneous_clients.py

on the CUDA GPU; ``--device cpu`` runs it on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.data import build_federated_image_task  # noqa: E402
from repro_torch.fl import FLConfig, make_cnn_task, run_strategy  # noqa: E402
from repro_torch.fl.decentralized import run_dpsgd  # noqa: E402

LEVELS = [0.2, 0.4, 0.6, 0.8, 1.0]


def main(argv=None) -> dict:
    """Print DisPFL's accuracy per capacity group and the D-PSGD-FT bound
    at 20% of the parameters; returns both ``FLResult``s."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--samples-per-class", type=int, default=80)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    k = args.clients
    clients, _ = build_federated_image_task(
        seed=1, n_clients=k, partition="pathological", classes_per_client=2,
        n_train_per_class=args.samples_per_class, hw=16)
    task = make_cnn_task("smallcnn", 10, 16, width=12, device=args.device)
    caps = [LEVELS[i % 5] for i in range(k)]
    cfg = FLConfig(n_clients=k, rounds=args.rounds,
                   local_epochs=args.epochs, batch_size=32, degree=4,
                   capacities=caps, eval_every=4)

    res = run_strategy("dispfl", task, clients, cfg)
    print(f"DisPFL (heterogeneous capacities): acc={res.final_acc:.3f}")
    accs = np.array(res.final_accs)
    for lvl in LEVELS:
        sel = [i for i, c in enumerate(caps) if c == lvl]
        if sel:
            print(f"  capacity {int(lvl*100):3d}% -> acc "
                  f"{accs[sel].mean():.3f}")

    # baseline confined to the weakest device
    res_d = run_dpsgd(task, clients, cfg, finetune=True, param_fraction=0.2)
    print(f"D-PSGD-FT @20% params (weakest-device bound): "
          f"acc={res_d.final_acc:.3f}")
    return {"dispfl": res, "dpsgd_ft": res_d}


if __name__ == "__main__":
    main()
