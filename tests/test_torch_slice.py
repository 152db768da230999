"""Slice gate of the PyTorch port: the DisPFL training round, started from
one reference archive, against the JAX reference — plus a CLI smoke and the
rule that the port imports neither jax nor ``repro``.

Tolerance: masks, comm rows, FLOPs, lr, prune rate and accuracies must be
equal; parameters agree to fp32 rounding of the convolutions, stated as
atol 1e-6 (the measured gap after 3 rounds is ~3e-8).  The same holds with
fp16 payload values: both packages round the same fp32 values to fp16
before the mix, so the cast adds no gap between them.
"""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.data import build_federated_image_task
from repro.fl import FLConfig, RoundEngine, make_cnn_task, make_strategy
from repro.utils.tree import tree_leaves_with_path as ref_leaves
from repro_torch.data.loader import build_federated_image_task as port_build
from repro_torch.fl.base import FLConfig as PortFLConfig
from repro_torch.fl.base import make_cnn_task as port_make_task
from repro_torch.fl.engine import RoundEngine as PortEngine
from repro_torch.fl.engine import make_strategy as port_make_strategy
from repro_torch.launch import train as port_train
from repro_torch.sparse.packed import is_packed
from repro_torch.utils.tree import tree_leaves as port_tree_leaves
from repro_torch.utils.tree import tree_leaves_with_path as port_leaves
from repro_torch.utils.tree import tree_map as port_tree_map
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.tier1

PARAM_ATOL = 1e-6
DATA = dict(n_clients=4, partition="pathological", classes_per_client=2,
            n_train_per_class=24, n_test_per_client=16, hw=8, noise=0.7)
CFG = dict(n_clients=4, rounds=3, local_epochs=1, batch_size=16, degree=2,
           eval_every=1)


def _assert_trees(ref_tree, port_tree, exact: bool, what: str):
    ra, pa = ref_leaves(ref_tree), port_leaves(port_tree)
    assert [p for p, _ in ra] == [p for p, _ in pa], what
    for (path, x), (_, y) in zip(ra, pa):
        x, y = np.asarray(x), y.detach().cpu().numpy()
        if exact:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{what} {path}")


@pytest.mark.parametrize("name,kw", [
    pytest.param("dispfl", {}, id="dispfl"),
    pytest.param("dispfl_anneal", {}, id="dispfl_anneal"),
    pytest.param("dispfl", {"payload_dtype": "fp16"}, id="dispfl-fp16"),
])
def test_slice_gate_matches_reference_from_one_archive(name, kw, tmp_path):
    clients, _ = build_federated_image_task(0, **DATA)
    ref = RoundEngine(make_strategy(name, **kw),
                      make_cnn_task("smallcnn", 10, 8, width=4),
                      clients, FLConfig(**CFG), local_exec="loop")
    archive = str(tmp_path / "round0.npz")
    ref.save(archive)
    port_clients, _ = port_build(0, **DATA)
    port = PortEngine(port_make_strategy(name, **kw),
                      port_make_task("smallcnn", 10, 8, width=4, device="cpu"),
                      port_clients, PortFLConfig(**CFG), local_exec="loop")
    port.restore(archive)
    wire = torch.float16 if kw.get("payload_dtype") == "fp16" else torch.float32
    msg = port.strategy.snapshot_message(port.state, 0)["packed"]
    assert set(port_tree_leaves(port_tree_map(
        lambda p: p.values.dtype, msg, is_leaf=is_packed))) == {wire}
    n_rounds = 0
    for a, b in zip(ref.rounds(), port.rounds()):
        ra, rb = a.to_dict(), b.to_dict()
        ra.pop("wall_s"), rb.pop("wall_s")
        assert ra == rb, (ra, rb)          # comm rows, FLOPs, acc, lr, rate
        for k in range(CFG["n_clients"]):
            _assert_trees(ref.state["masks"][k], port.state["masks"][k],
                          True, f"round {a.round} client {k} mask")
            _assert_trees(ref.state["params"][k], port.state["params"][k],
                          False, f"round {a.round} client {k} params")
        n_rounds += 1
    assert n_rounds == CFG["rounds"]
    assert ref.result().final_accs == port.result().final_accs


def test_cli_smoke_on_cpu(tmp_path, capsys):
    jsonl = tmp_path / "rounds.jsonl"
    out = port_train.main([
        "simulate", "--strategy", "dispfl", "--rounds", "2", "--clients", "3",
        "--local-epochs", "1", "--samples-per-class", "8", "--hw", "8",
        "--width", "4", "--degree", "2", "--exec", "loop", "--device", "cpu",
        "--log-jsonl", str(jsonl), "--checkpoint", str(tmp_path / "ck.npz")])
    assert out["device"] == "cpu"
    assert len(out["phase_s"]) == 2 and len(out["round_wall_s"]) == 2
    assert set(out["phase_s"][0]) == {"mix", "local", "evolve", "eval"}
    assert np.isfinite(out["final_acc"])
    assert len(jsonl.read_text().splitlines()) == 2
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):])["strategy"] == "dispfl"
    # resuming a finished run continues at its end
    again = port_train.main([
        "simulate", "--rounds", "2", "--clients", "3", "--local-epochs", "1",
        "--samples-per-class", "8", "--hw", "8", "--width", "4",
        "--degree", "2", "--device", "cpu",
        "--resume", str(tmp_path / "ck.npz")])
    assert again["acc_history"] == out["acc_history"]


def test_entry_points_refuse_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_make_task("smallcnn", 10, 8, width=4)


def test_port_imports_neither_jax_nor_reference():
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    examples = sorted((root / "examples").glob("torch_*.py"))
    assert len(examples) == 7
    files += examples
    assert len(files) > 20
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{f.relative_to(root)}: {n}")
    assert not bad, bad
