"""Personalized sparse serving on the PyTorch port: the ``repro_torch.serve``
plane end to end — packed delta store, LRU slot cache, micro-batched
launches — first over the matmul-pipeline MLP (``ref`` backend), then over
a smoke arch (reduced config, ``vmap`` backend)
(``examples/serve_personalized.py`` through ``repro_torch``).

    PYTHONPATH=src python examples/torch_serve_personalized.py [arch]

Both runs call the serving CLI's ``main`` in this process
(``repro_torch.launch.serve``), on the card unless ``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch import serve  # noqa: E402


def main(argv=None) -> dict:
    """Run both servings (JSON lines, the last the summary); returns
    ``{"mlp": summary, arch: summary}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="gemma3-1b")
    ap.add_argument("--users", type=int, default=32)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--arch-users", type=int, default=4)
    ap.add_argument("--arch-requests", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = ["--device", args.device]
    mlp = serve.main(
        ["--model", "mlp", "--backend", "ref", "--users", str(args.users),
         "--cache-size", "8", "--max-batch", "8", "--requests",
         str(args.requests), "--density", "0.3", *dev])
    arch = serve.main(
        ["--model", args.arch, "--backend", "vmap", "--users",
         str(args.arch_users), "--cache-size", "2", "--max-batch", "2",
         "--requests", str(args.arch_requests), "--rows", "1", *dev])
    return {"mlp": mlp, args.arch: arch}


if __name__ == "__main__":
    main()
