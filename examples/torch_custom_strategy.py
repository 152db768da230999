"""Adding a strategy to the port's zoo in <100 lines: DFedProx
(``examples/custom_strategy.py`` through ``repro_torch``).

A decentralized FedProx variant — Metropolis gossip mixing (as D-PSGD) but
each client's local phase adds a proximal pull toward the model it received
from its neighbourhood, damping client drift under non-IID data.  Only
three hooks differ from the defaults; topology sampling, eval cadence,
streaming metrics, checkpointing and comm/FLOP accounting all come from
``RoundEngine``.  The tree arithmetic is ``repro_torch.utils.tree``'s, and
the initial params come from a ``torch.Generator`` seeded with
``cfg.seed``.

    PYTHONPATH=src python examples/torch_custom_strategy.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.accounting import (  # noqa: E402
    decentralized_comm,
    sparse_training_flops,
)
from repro_torch.data import build_federated_image_task  # noqa: E402
from repro_torch.fl import (  # noqa: E402
    FLConfig,
    RoundEngine,
    make_cnn_task,
    make_strategy,
    register,
)
from repro_torch.fl.decentralized import metropolis_weights  # noqa: E402
from repro_torch.fl.engine import StrategyBase  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    tree_add,
    tree_scale,
    tree_size,
    tree_sub,
)


@register("dfedprox")
class DFedProx(StrategyBase):
    """State: {"params": [K trees]}.  mu is the proximal strength."""

    def __init__(self, mu: float = 0.1):
        self.mu = mu

    def init_state(self, task, clients, cfg):
        super().init_state(task, clients, cfg)
        gen = torch.Generator().manual_seed(cfg.seed)
        params = [task.init_fn(gen) for _ in clients]
        self.n_coords = tree_size(params[0])
        return {"params": params}

    def mix(self, state, ctx):
        w = metropolis_weights(ctx.adjacency)
        params = state["params"]
        mixed = []
        for k in range(len(params)):
            acc = None
            for j, p in enumerate(params):
                if w[k, j] != 0.0:
                    term = tree_scale(p, float(w[k, j]))
                    acc = term if acc is None else tree_add(acc, term)
            mixed.append(acc)
        state["params"] = mixed

    def local_update(self, state, k, ctx):
        c, cfg = self.clients[k], ctx.cfg
        rng = ctx.client_rng(k)
        ref = state["params"][k]                       # neighbourhood model
        w = ref
        bs = min(cfg.batch_size, c.n_train)
        for _ in range(cfg.local_epochs):
            order = torch.as_tensor(rng.permutation(c.n_train),
                                    device=c.train_y.device)
            for i in range(0, len(order), bs):
                s = order[i: i + bs]
                _, g = self.task.value_and_grad(w, c.train_x[s], c.train_y[s])
                pull = tree_add(tree_add(g, tree_scale(w, cfg.weight_decay)),
                                tree_scale(tree_sub(w, ref), self.mu))
                w = tree_sub(w, tree_scale(pull, ctx.lr))
        state["params"][k] = w

    def round_comm(self, state, ctx):
        return decentralized_comm(ctx.adjacency,
                                  [self.n_coords] * len(self.clients),
                                  self.n_coords)

    def round_flops(self, state, ctx):
        return sparse_training_flops(
            self.task.fwd_flops, {k: 1.0 for k in self.task.fwd_flops},
            self.n_samples, ctx.cfg.local_epochs, mask_search_batches=0,
            batch_size=ctx.cfg.batch_size)


def main(argv=None):
    """Stream the rounds' rows and the final accuracy; returns the
    engine's ``FLResult``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--samples-per-class", type=int, default=60)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    clients, _ = build_federated_image_task(
        seed=0, n_clients=args.clients, partition="pathological",
        classes_per_client=2, n_train_per_class=args.samples_per_class,
        n_test_per_client=30, hw=16, noise=0.8)
    task = make_cnn_task("smallcnn", n_classes=10, hw=16, width=8,
                         device=args.device)
    cfg = FLConfig(n_clients=args.clients, rounds=args.rounds,
                   local_epochs=args.epochs, batch_size=32, degree=3,
                   eval_every=2)
    engine = RoundEngine(make_strategy("dfedprox", mu=0.1), task, clients,
                         cfg)
    for m in engine.rounds():                          # streaming metrics
        acc = (f"acc={m.acc_mean:.3f}±{m.acc_std:.3f}"
               if m.acc_mean is not None else "")
        print(f"round {m.round + 1}/{cfg.rounds} lr={m.lr:.3f} "
              f"comm={m.comm_busiest_mb:.2f}MB {acc}")
    res = engine.result()
    print(f"final personalized acc: {res.final_acc:.3f} "
          f"(per-client std {np.std(res.final_accs):.3f})")
    return res


if __name__ == "__main__":
    main()
