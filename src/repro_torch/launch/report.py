"""Render the §Dry-run / §Roofline tables from dry-run artifacts
(reference ``repro.launch.report``).  Roofline terms are recomputed from
the stored cost/collective numbers with the current hardware model
(``launch.roofline``), so the artifacts don't go stale when the roofline
code improves.  It reads the port's artifacts (mesh ``h100x1``, and its
fake-world ``pod16x16`` and ``pod2x16x16`` records) and the reference's
(``pod16x16``, ``pod2x16x16``) alike; on one card the collective columns
read 0.  A port mesh record says ``"tp": true``: its ranks split each
client over 'model', as the reference's do, so it is tabled beside the
reference's record of the same mesh, its row marked ``PORT_ROW``.  A
record that says ``"tp": false`` (a rank computed whole clients,
replicated over 'model': the port before tensor parallelism) is tabled
under a mesh heading of its own (``table_mesh``), never beside the
reference's records.  A port record of either kind also gets the fit
table: rank 0's peak live bytes against one card's memory.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir D]

A record of a ``--remat`` other than the default ``full`` (its tag ends
``__remat_<p>``, as the reference's) is its own row, the arch cell
marked `` [remat <p>]``.

A port record carries the plan it traced (``seq_len``, ``global_batch`` =
K x rows, ``dtype``): its roofline prices that batch at that dtype's peak.
A reference record carries none, and is priced as the reference prices
it: at its input shape's batch, at the bf16 peak.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

from repro_torch.configs import ARCHS, INPUT_SHAPES, SMOKE_ARCHS
from repro_torch.launch.roofline import build_report

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "torch_dryrun")
MESHES = ("h100x1", "pod16x16", "pod2x16x16")
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: the heading suffix of a port mesh record that says ``"tp": false``
REPLICATED = " (port: whole clients a rank, no tensor parallelism)"
#: the arch cell's suffix of a port mesh record that says ``"tp": true``,
#: tabled beside the reference's row of the same arch and shape
PORT_ROW = " (port)"


def table_mesh(rec: dict) -> str:
    """The mesh a record is tabled under: its own, or for a port mesh
    record (no tensor parallelism) its own with ``REPLICATED``."""
    return rec["mesh"] + (REPLICATED if rec.get("tp") is False else "")


def _source(rec: dict) -> str:
    """``PORT_ROW`` for a port mesh record tabled beside the reference's
    (``"tp": true``); else nothing."""
    return PORT_ROW if rec.get("tp") is True else ""


def load_records(art_dir: str = ART_DIR, gossip: str = "einsum") -> list[dict]:
    """Load artifacts, one per tag (an ``ok`` record wins over another);
    smoke records (``test`` meshes) are left out, as in the reference."""
    by_tag: dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("gossip", "einsum") != gossip:
            continue
        if "test" in rec.get("mesh", ""):
            continue
        key = table_mesh(rec) + rec["tag"] + _source(rec)
        if rec.get("status") == "ok" or key not in by_tag:
            by_tag[key] = rec
    return list(by_tag.values())


def fresh_report(rec: dict):
    arch = (SMOKE_ARCHS if rec.get("smoke") else ARCHS)[rec["arch"]]
    shape = INPUT_SHAPES[rec["shape"]]
    if "global_batch" in rec:
        shape = dataclasses.replace(shape, seq_len=rec["seq_len"],
                                    global_batch=rec["global_batch"])
    return build_report(arch, shape, rec["mesh"], rec["chips"], rec["cost"],
                        rec["coll_bytes_per_device"],
                        dtype=rec.get("dtype", "bf16"))


def _arch(rec: dict) -> str:
    """The table's arch cell: the arch, marked with its ``--remat`` where
    not ``full`` and (``_source``) for a port mesh record tabled beside
    the reference's."""
    remat = rec.get("remat", "full")
    return (rec["arch"] + (f" [remat {remat}]" if remat != "full" else "")
            + _source(rec))


def _order(arch: str, shape: str) -> tuple[int, int, str]:
    """Arch, then shape, then the reference's row before the port's
    ones."""
    name = arch.split(" ")[0]
    return list(ARCHS).index(name), SHAPE_ORDER.index(shape), arch


def roofline_table(records: list[dict], mesh: str) -> str:
    hdr = ("| arch | shape | K | mode | compute (ms) | memory (ms) "
           "| collective (ms) | bound | 6ND/HLO | HBM GB/dev |\n"
           "|---|---|--:|---|--:|--:|--:|---|--:|--:|\n")
    lines = []
    for rec in records:
        if table_mesh(rec) != mesh:
            continue
        if rec["status"] == "skipped":
            lines.append((_arch(rec), rec["shape"],
                          f"| {_arch(rec)} | {rec['shape']} | — | — | — | — "
                          f"| — | skipped | — | — |"))
            continue
        if rec["status"] != "ok":
            lines.append((_arch(rec), rec["shape"],
                          f"| {_arch(rec)} | {rec['shape']} | — | FAILED | | | | | | |"))
            continue
        r = fresh_report(rec)
        arg_gb = rec.get("memory", {}).get("argument_size_in_bytes", 0) / 1e9
        mode = "u" if rec.get("unroll") else "s"
        lines.append((_arch(rec), rec["shape"], (
            f"| {_arch(rec)} | {rec['shape']} | {rec['n_clients']} | {mode} "
            f"| {r.compute_s*1e3:.2f} | {r.memory_s*1e3:.2f} "
            f"| {r.collective_s*1e3:.2f} | **{r.bottleneck}** "
            f"| {r.useful_ratio:.2f} | {arg_gb:.2f} |")))
    lines.sort(key=lambda t: _order(t[0], t[1]))
    return hdr + "\n".join(l for _, _, l in lines) + "\n"


def dryrun_table(records: list[dict], mesh: str) -> str:
    hdr = ("| arch | shape | K | compile (s) | HLO GFLOP/dev | HBM GB/dev | "
           "coll GB/dev | top collectives |\n"
           "|---|---|--:|--:|--:|--:|--:|---|\n")
    lines = []
    for rec in records:
        if table_mesh(rec) != mesh or rec["status"] != "ok":
            continue
        counts = rec["collectives"].get("counts", {})
        top = ", ".join(f"{k}x{v}" for k, v in
                        sorted(counts.items(), key=lambda kv: -kv[1])[:3])
        lines.append((_arch(rec), rec["shape"], (
            f"| {_arch(rec)} | {rec['shape']} | {rec['n_clients']} "
            f"| {rec['compile_s']:.0f} | {rec['cost']['flops']/1e9:.1f} "
            f"| {rec['cost']['bytes accessed']/1e9:.1f} "
            f"| {rec['coll_bytes_per_device']/1e9:.2f} | {top} |")))
    lines.sort(key=lambda t: _order(t[0], t[1]))
    return hdr + "\n".join(l for _, _, l in lines) + "\n"


def fit_table(records: list[dict], mesh: str = "h100x1") -> str:
    """The port's own columns: the dtype, the trace's seconds, the peak
    live bytes (on a mesh, rank 0's) against the card's memory, and whether
    the step fits.  Reference records (no peak) are left out."""
    hdr = ("| arch | shape | K x rows | dtype | trace (s) | peak GiB "
           "| card GiB | fits |\n|---|---|--:|---|--:|--:|--:|---|\n")
    lines = []
    for rec in records:
        if (table_mesh(rec) != mesh or rec["status"] != "ok"
                or "peak_live_bytes" not in rec):
            continue
        lines.append((_arch(rec), rec["shape"], (
            f"| {_arch(rec)} | {rec['shape']} "
            f"| {rec['n_clients']} x {rec['per_client_batch']} "
            f"| {rec['dtype']} | {rec['trace_s']:.1f} "
            f"| {rec['peak_live_bytes'] / 2 ** 30:.2f} "
            f"| {rec['device_memory_bytes'] / 2 ** 30:.2f} "
            f"| {'yes' if rec['fits'] else 'no'} |")))
    lines.sort(key=lambda t: _order(t[0], t[1]))
    return hdr + "\n".join(l for _, _, l in lines) + "\n"


def render(art_dir: str = ART_DIR) -> tuple[str, str]:
    """Returns (dryrun_md, roofline_md) for EXPERIMENTS.md embedding."""
    records = load_records(art_dir)
    dr = []
    rf = []
    for mesh in MESHES:
        dr.append(f"\n#### Dry-run — {mesh}\n\n" + dryrun_table(records, mesh))
        rf.append(f"\n#### Roofline — {mesh} (mode s: every layer's ops "
                  f"counted)\n\n" + roofline_table(records, mesh))
    return "".join(dr), "".join(rf)


def write_experiments(path: str, art_dir: str = ART_DIR) -> None:
    with open(path) as f:
        text = f.read()
    dr, rf = render(art_dir)
    text = text.replace("<!-- DRYRUN_TABLES -->", dr)
    text = text.replace("<!-- ROOFLINE_TABLES -->", rf)
    with open(path, "w") as f:
        f.write(text)
    print(f"updated {path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--dir", default=ART_DIR)
    ap.add_argument("--gossip", default="einsum")
    ap.add_argument("--write-experiments", default="",
                    help="patch the marker sections of this EXPERIMENTS.md")
    args = ap.parse_args(argv)
    if args.write_experiments:
        write_experiments(args.write_experiments, args.dir)
        return
    records = load_records(args.dir, args.gossip)
    for mesh in sorted({table_mesh(r) for r in records},
                       key=lambda m: (m not in MESHES, m)):
        print(f"\n### Dry-run — {mesh}\n")
        print(dryrun_table(records, mesh))
        print(f"\n### Roofline — {mesh}\n")
        print(roofline_table(records, mesh))
        if any("peak_live_bytes" in r for r in records
               if table_mesh(r) == mesh):
            print(f"\n### Fit on one card — {mesh}\n")
            print(fit_table(records, mesh))


if __name__ == "__main__":
    main()
