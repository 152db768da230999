"""Seconds of an unsharded ``ScaleEngine`` round on the card, at the two
cells the client-sharded round is checked at: ResNet18-GN at 32x32, K=4
(``chip_smoke.py``'s phase 5 cell, ``einsum``) and K=8 with a batch of 8
(phase 20 (b)'s, ``ordered``).  The round step is graphed, so the first
round captures it and the later rounds replay it.

    PYTHONPATH=src python3 tools/scale_round_cost.py [--src DIR] [--rounds N]

``--src`` imports the port from another source tree (a parent commit's
``src``, unpacked with ``git archive`` into a git-ignored directory), so
two trees compare in one call on one card, each in a process of its own.
Prints the card's name and power limit, then one JSON line a cell: the
tree, the round walls, the median wall of the replayed rounds (the
second on) and each round's phase seconds.  Card only (the CLI refuses to
start without a GPU).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

CELLS = {
    "K=4 einsum": ["--clients", "4"],
    "K=8 ordered": ["--clients", "8", "--batch-size", "8",
                    "--scale-reduction", "ordered"],
}
BASE = ["simulate", "--scale", "--model", "resnet18", "--hw", "32",
        "--local-epochs", "1", "--samples-per-class", "20"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.launch import train

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    for name, extra in CELLS.items():
        out = train.main(BASE + extra + ["--rounds", str(args.rounds)])
        walls = out["round_wall_s"]
        print(json.dumps({"src": os.path.abspath(args.src), "cell": name,
                          "round_wall_s": walls,
                          "replay_median_s": statistics.median(walls[1:]),
                          "phase_s": out["phase_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
