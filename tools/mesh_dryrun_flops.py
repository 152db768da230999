"""Rank 0's figures of meshed dry-run records, for one source tree.

    PYTHONPATH=src python3 tools/mesh_dryrun_flops.py [--src DIR]
        [--case ARCH:SHAPE:MESH[:GOSSIP] ... | --all] [--jobs N]
        [--remat full|dots|none]

Each case (default: qwen3-8b and gemma3-1b train_4k on pod16x16 and on
pod2x16x16, published widths, bf16, ``einsum`` gossip unless the case
names another) runs
``repro_torch.launch.dryrun.run_one`` of the tree at ``--src`` (default
this checkout's ``src``) in a process of its own, on fake CPU tensors of a
fake world of 256 or 512 ranks, and prints one JSON line: the record's
FLOPs, bytes accessed, peak live bytes, collective bytes and counts a
rank, ``tp`` and ``replicated`` where the tree writes them, and the
trace's seconds.  ``--all`` takes every arch x input shape on both
meshes (the dry run's ``--both-meshes`` sweep; long_500k of the
full-attention archs is skipped, as the dry run skips it), ``--jobs`` runs
that many cases at once.  ``--remat`` traces the models under that
rematerialisation (the dry run's ``--remat``; a tree from before it
takes none, and runs without ``--remat``).  Run it on two trees (``git archive`` of the
other into a git-ignored directory) to set their records side by side.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [f"{a}:train_4k:{m}" for a in ("qwen3-8b", "gemma3-1b")
         for m in ("pod16x16", "pod2x16x16")]
CODE = """
import json, sys
from repro_torch.launch import dryrun
arch, shape, mesh, gossip, out, remat = sys.argv[1:7]
rec = dryrun.run_one(arch, shape, gossip=gossip, out_dir=out, verbose=False,
                     device="cpu", multi_pod=mesh == "pod2x16x16",
                     **({"remat": remat} if remat else {}))
print(json.dumps({k: rec.get(k) for k in (
    "arch", "shape", "mesh", "gossip", "remat", "chips", "n_clients",
    "per_client_batch",
    "fsdp2d", "tp", "replicated", "cost", "peak_live_bytes", "fits",
    "coll_bytes_per_device", "collectives", "trace_s")}))
"""


def _every_case() -> list:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import ARCHS, INPUT_SHAPES
    return [f"{a}:{s}:{m}" for m in ("pod16x16", "pod2x16x16")
            for a in ARCHS for s in INPUT_SHAPES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/mesh_dryrun_flops.py")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--case", action="append", default=None,
                    help="ARCH:SHAPE:MESH[:GOSSIP] (pod16x16 or "
                         "pod2x16x16; einsum by default)")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape on both meshes")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--remat", default="", choices=["", "full", "dots",
                                                    "none"],
                    help="the models' rematerialisation (default: the "
                         "tree's own default)")
    args = ap.parse_args(argv)
    env = {**os.environ, "PYTHONPATH": os.path.abspath(args.src),
           "OMP_NUM_THREADS": "1"}
    cases = _every_case() if args.all else args.case or CASES
    with tempfile.TemporaryDirectory() as out:
        def one(case):
            arch, shape, mesh, gossip = (case.split(":") + ["einsum"])[:4]
            r = subprocess.run([sys.executable, "-c", CODE, arch, shape,
                                mesh, gossip, out, args.remat], env=env,
                               capture_output=True, text=True, timeout=1200)
            if r.returncode:
                return {"case": case, "src": args.src,
                        "error": r.stderr[-2000:]}
            return {"src": args.src,
                    **json.loads(r.stdout.strip().splitlines()[-1])}

        with ThreadPoolExecutor(max(1, args.jobs)) as pool:
            rows = list(pool.map(one, cases))
    for row in rows:
        print(json.dumps(row))
    return int(any("error" in row for row in rows))


if __name__ == "__main__":
    sys.exit(main())
