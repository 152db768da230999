"""Asynchronous DisPFL on a simulated heterogeneous network, on the PyTorch
port (``examples/async_gossip.py`` through ``repro_torch``).

Eight clients with 0.2x..1.0x compute speeds train decentralized sparse
models through ``repro_torch.sim.SimEngine``, three times on identical
data:

* synchronous barrier — every round waits for the slowest client,
* async gossip (staleness <= 2) — fast clients keep training and mix
  whichever neighbour models have physically arrived,
* async on *faulty* links — every message risks a 15% Bernoulli drop
  (resent after a timeout, retransmitted bytes measured on the wire) and
  each sender's concurrent pushes serialize FIFO on one shared uplink.

Messages are packed trees (uint32 mask bitmap + the nnz values), each
activation mixes them with the ``mix_one`` hook (the packed-fold kernel on
the card), and every simulated transfer is stamped with the exact
wire-codec frame size.

    PYTHONPATH=src python examples/torch_async_gossip.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.data import build_federated_image_task  # noqa: E402
from repro_torch.fl import FLConfig, make_cnn_task, make_strategy  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    LinkModel,
    LossModel,
    SimEngine,
    hetero_speeds,
    measure_payload,
)
from repro_torch.sim.report import time_to_target  # noqa: E402
from repro_torch.utils.tree import tree_bytes  # noqa: E402


def main(argv=None) -> dict:
    """Print the one-message sizes, each engine's rounds and its report;
    returns ``{"message": (value, wire, dense bytes), "engines": {...}}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--samples-per-class", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    k = args.clients
    clients, _ = build_federated_image_task(
        0, n_clients=k, partition="dirichlet", alpha=0.3,
        n_train_per_class=args.samples_per_class, n_test_per_client=24,
        hw=8, noise=0.8)
    task = make_cnn_task("smallcnn", n_classes=10, hw=8, width=8,
                         device=args.device)
    cfg = FLConfig(n_clients=k, rounds=args.rounds,
                   local_epochs=args.epochs, batch_size=16, degree=3,
                   eval_every=2)

    speeds = hetero_speeds(k, seed=0)          # 0.2x .. 1.0x, shuffled
    links = LinkModel.uniform(k, mbps=50, latency_ms=20)
    print(f"clients={k} speeds={[round(float(s), 1) for s in speeds]}")

    engines = {
        "sync": SimEngine(make_strategy("dispfl"), task, clients, cfg,
                          mode="sync", links=links, round_s=1.0,
                          compute_speeds=speeds),
        "async": SimEngine(make_strategy("dispfl"), task, clients, cfg,
                           mode="async", staleness=2, links=links,
                           round_s=1.0, compute_speeds=speeds),
        "lossy": SimEngine(make_strategy("dispfl"), task, clients, cfg,
                           mode="async", staleness=2, links=links,
                           round_s=1.0, compute_speeds=speeds,
                           uplink="fifo",
                           loss=LossModel(0.15, timeout_s=0.25, seed=0)),
    }

    # what one message physically is: the codec frame of a packed tree
    payload = engines["sync"].strategy.snapshot_message(
        engines["sync"].state, 0)
    val_b, wire_b = measure_payload(payload)
    dense_b = tree_bytes(engines["sync"].state["params"][0])
    print(f"one message: {wire_b} B on the wire "
          f"({val_b:.0f} B values + bitmap/header) vs {dense_b} B dense "
          f"-> {wire_b / dense_b:.0%} of the dense tree")

    for mode, eng in engines.items():
        for m in eng.rounds():
            if m.acc_mean is not None:
                print(f"  [{mode}] round {m.round + 1:2d} "
                      f"acc={m.acc_mean:.3f} t_sim={m.sim_time_s:7.2f}s "
                      f"busiest={m.busiest_up_mb:.2f}MB up")

    target = min(max(a for _, a in e.acc_trace)
                 for e in engines.values()) - 1e-9
    print(f"\ncommon target accuracy: {target:.3f}")
    for mode, eng in engines.items():
        hit = time_to_target(eng.acc_trace, target)
        rep = eng.report(targets=(target,))
        print(f"{mode:>5}: wall={eng.sim_time:7.2f}s  to-target={hit:7.2f}s  "
              f"busiest-node={rep.busiest_node} "
              f"({rep.busiest_up_mb:.2f}MB up / "
              f"{rep.busiest_down_mb:.2f}MB down)")
    print(f"async observed staleness spread: "
          f"{engines['async'].observed_spread} rounds "
          f"(bound {engines['async'].staleness})")

    # the price of unreliable links, measured from what was actually resent
    lossy = engines["lossy"].stats
    clean = engines["async"].stats
    print(f"lossy links: {lossy.n_retransmits} retransmits = "
          f"{lossy.retrans_mb:.3f}MB extra on the wire "
          f"({lossy.retrans_mb / lossy.total_mb:.0%} of its "
          f"{lossy.total_mb:.2f}MB total; clean async moved "
          f"{clean.total_mb:.2f}MB), {lossy.n_lost} message(s) lost for good")
    return {"message": (val_b, wire_b, dense_b), "engines": engines}


if __name__ == "__main__":
    main()
