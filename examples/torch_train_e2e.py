"""End-to-end driver on the PyTorch port: DisPFL-train a transformer LM on
synthetic non-IID corpora (one Markov domain per client)
(``examples/train_e2e.py`` through ``repro_torch``).

Default is small (a d_model 256, 2-layer smoke arch, 200 steps a round,
10 rounds).  For a ~100M-parameter model:

    PYTHONPATH=src python examples/torch_train_e2e.py --d-model 768 \
        --layers 12 --steps 300 --clients 4

This calls ``repro_torch.launch.train lm``'s ``main`` in this process — the
code path of the stacked train step (gossip_average_stacked + masked SGD +
mask evolution), on the card unless ``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import train  # noqa: E402


def main(argv=None) -> dict:
    """Run ``train lm``; returns its summary (``{"arch", "improved"}``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--clients", default="4")
    ap.add_argument("--steps", default="200")
    ap.add_argument("--rounds", default="10")
    ap.add_argument("--d-model", default="256", dest="d_model")
    ap.add_argument("--layers", default="2")
    ap.add_argument("--seq", default="128")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    return train.main(
        ["lm", "--arch", args.arch, "--clients", args.clients, "--steps",
         args.steps, "--rounds", args.rounds, "--d-model", args.d_model,
         "--layers", args.layers, "--seq", args.seq, "--device",
         args.device])


if __name__ == "__main__":
    main()
