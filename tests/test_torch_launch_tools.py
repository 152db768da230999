"""The port's launch tooling against the reference's: the roofline
(``repro_torch.launch.roofline`` vs ``repro.launch.roofline``), the
single-card dry run (``repro_torch.launch.dryrun``) and its cost counter
(``repro_torch.utils.trace_cost``), and the report
(``repro_torch.launch.report`` vs ``repro.launch.report``).

The analytic counts equal the reference's exactly.  The roofline's
arithmetic equals the reference's under the reference's constants (patched
into the port); the port's own constants are the H100's.  The dry run
traces on ``cpu`` fake tensors here (on this CPU-only torch a fake
``cuda`` tensor fails at the first advanced index), and its counts equal
the same step run for real.
"""
import dataclasses
import json
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as ref_configs
from repro.launch import report as ref_report
from repro.launch import roofline as ref_roofline
from repro_torch import configs
from repro_torch.launch import dryrun, report, roofline, train
from repro_torch.models import bind
from repro_torch.utils.trace_cost import step_cost

pytestmark = pytest.mark.tier1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The traces dispatch thousands of small ops; under the suite's
    parallel workers torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's roofline priced as the reference's (its bf16 peak, HBM
    and link rates)."""
    monkeypatch.setitem(roofline.PEAK_FLOPS_BY_DTYPE, "bf16",
                        ref_roofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", ref_roofline.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", ref_roofline.ICI_BW)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(configs.ARCHS))
def test_param_counts_and_model_flops_equal_reference(name):
    for table, ref_table in ((configs.ARCHS, ref_configs.ARCHS),
                             (configs.SMOKE_ARCHS, ref_configs.SMOKE_ARCHS)):
        cfg, ref_cfg = table[name], ref_table[name]
        assert roofline.active_params(cfg) == ref_roofline.active_params(
            ref_cfg)
        assert roofline.total_params(cfg) == ref_roofline.total_params(
            ref_cfg)
        for shape_name, shape in configs.INPUT_SHAPES.items():
            ref_shape = ref_configs.INPUT_SHAPES[shape_name]
            for density in (1.0, 0.5):
                assert roofline.model_flops(cfg, shape, density) == \
                    ref_roofline.model_flops(ref_cfg, ref_shape, density)


COSTS = [  # (chips, flops, bytes accessed, collective bytes, model flops)
    (1, 1.3e13, 4.7e11, 0.0, 1.2e13),
    (256, 2.0e12, 9.0e9, 3.0e9, 4.0e14),
    (1, 0.0, 0.0, 0.0, 5.0),
    (512, 1e9, 1e12, 0.0, 1e11),
]


@pytest.mark.parametrize("chips,flops,bts,coll,mf", COSTS)
def test_finalize_and_row_equal_reference_under_its_constants(
        reference_constants, chips, flops, bts, coll, mf):
    kw = dict(arch="a", shape="s", mesh="m", chips=chips,
              per_device_flops=flops, per_device_bytes=bts,
              per_device_coll_bytes=coll, model_flops_global=mf)
    got = roofline.RooflineReport(**kw).finalize()
    want = ref_roofline.RooflineReport(**kw).finalize()
    fields = dataclasses.asdict(got)
    assert fields.pop("dtype") == "bf16"
    assert fields == dataclasses.asdict(want)
    assert got.row() == want.row()


def test_report_prices_its_dtype_on_the_h100_and_one_card_has_no_link():
    cfg, shape = configs.ARCHS["gemma3-1b"], configs.INPUT_SHAPES["train_4k"]
    cost = {"flops": 1.3e13, "bytes accessed": 4.7e11}
    bf16 = roofline.build_report(cfg, shape, "h100x1", 1, cost, 0.0)
    fp32 = roofline.build_report(cfg, shape, "h100x1", 1, cost, 0.0,
                                 dtype="fp32")
    assert bf16.compute_s == 1.3e13 / 989e12
    assert fp32.compute_s == 1.3e13 / 67e12
    assert bf16.memory_s == fp32.memory_s == 4.7e11 / 3.35e12
    for r in (bf16, fp32):
        assert r.collective_s == 0.0 and not math.isnan(r.mfu)
        assert r.model_flops_global == roofline.model_flops(cfg, shape)
    assert (bf16.bottleneck, fp32.bottleneck) == ("memory", "compute")
    empty = roofline.build_report(cfg, shape, "h100x1", 1, {}, 0.0)
    assert (empty.step_s, empty.mfu, empty.useful_ratio) == (0.0, 0.0, 0.0)


PHASES = {"round.mix": {"count": 4, "total_s": 0.5, "mean_s": 0.125,
                        "max_s": 0.2},
          "round.local": {"count": 2, "total_s": 3.0, "mean_s": 1.5,
                          "max_s": 1.6},
          "round.eval": {"count": 1, "total_s": 0.0, "mean_s": 0.0,
                         "max_s": 0.0}}


def test_measured_phase_rows_equal_reference_under_its_constants(
        reference_constants):
    for analytic in (None, {"round.mix": (3e9, "bytes"),
                            "round.local": (2e14, "flops"),
                            "round.eval": (1e6, "flops")}):
        assert roofline.measured_phase_rows(PHASES, analytic) == \
            ref_roofline.measured_phase_rows(PHASES, analytic)
    for mod in (roofline, ref_roofline):
        with pytest.raises(ValueError, match="flops|bytes"):
            mod.measured_phase_rows(PHASES, {"round.mix": (1.0, "seconds")})


# ---------------------------------------------------------------------------
# the cost counter and the dry run
# ---------------------------------------------------------------------------


def _view_then_add(x):
    a = x * 2
    return a.view(-1) + 1


@pytest.mark.parametrize("fake", [False, True])
def test_trace_cost_counts_bytes_once_and_frees_dead_storages(fake):
    def run():
        x = torch.ones((4, 4))
        return step_cost(_view_then_add, x)[1]

    if fake:
        with FakeTensorMode():
            cost = run()
    else:
        cost = run()
    # mul and add each read 64 B and write 64 B; the view moves nothing
    assert cost.bytes_accessed == 256
    assert cost.aten_ops == {"aten.mul": 1, "aten.add": 1}
    # x, a and the sum live together; a dies with the step
    assert (cost.argument_bytes, cost.peak_live_bytes) == (64, 192)
    assert (cost.output_bytes, cost.temp_bytes) == (64, 128)
    assert cost.flops == 0


@pytest.mark.parametrize("name,dtype", [("gemma3-1b", "fp32"),
                                        ("deepseek-moe-16b", "bf16"),
                                        ("mamba2-1.3b", "fp32")])
def test_fake_trace_counts_equal_the_real_step(name, dtype):
    """The CPU half of the card test in ``test_torch_cuda.py``: the same
    counters over the same step, on fake and on real tensors."""
    cfg = configs.SMOKE_ARCHS[name]
    plan = dryrun.make_plan(cfg, configs.InputShape("train_64", 64, 2,
                                                    "train"), 2, 1, dtype)
    fake, _ = dryrun.trace_plan(plan, device="cpu")
    api = bind(cfg)
    step, specs = dryrun.step_and_specs(api, plan)
    args = dryrun.materialize(specs, cfg.vocab, "cpu",
                              torch.Generator().manual_seed(0))
    _, real = step_cost(step, *args)
    assert fake.flops > 0
    assert dataclasses.asdict(fake) == dataclasses.asdict(real)


@pytest.mark.parametrize("arch,shape", [("qwen3-8b", "train_4k"),
                                        ("deepseek-moe-16b", "train_4k"),
                                        ("mamba2-1.3b", "decode_32k")])
def test_smoke_dryrun_cli_writes_ok_artifacts(tmp_path, arch, shape):
    """The reference's own smoke cases (tests/test_dryrun_integration.py)."""
    dryrun.main(["--smoke", "--device", "cpu", "--arch", arch, "--shape",
                 shape, "--out", str(tmp_path)])
    rec = json.loads((tmp_path / f"{arch}__{shape}__testh100x1.json")
                     .read_text())
    assert rec["status"] == "ok", rec
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")
    assert (rec["chips"], rec["n_clients"], rec["per_client_batch"]) == (
        1, 2, 1)
    assert rec["global_batch"] == 2
    assert rec["shape_global_batch"] == configs.INPUT_SHAPES[shape].global_batch
    assert rec["compile_s"] == 0 and rec["trace_s"] > 0
    assert rec["coll_bytes_per_device"] == 0.0
    assert rec["collectives"]["counts"] == {}
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] == \
        rec["peak_live_bytes"]
    assert rec["fits"] is True and rec["dtype"] == "bf16"
    assert rec["device_memory_bytes"] == dryrun.DATA_SHEET_MEMORY
    assert "data sheet" in rec["device_memory_source"]
    assert len(rec["aten_ops"]) <= 12 and "hlo_ops" not in rec
    assert "FlopCounterMode" in rec["flops_counted_by"]


def test_full_attention_arch_skips_long_500k(tmp_path):
    rec = dryrun.run_one("qwen3-8b", "long_500k", out_dir=str(tmp_path),
                         verbose=False)
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]
    assert json.loads((tmp_path / f"{rec['tag']}.json").read_text()) == rec
    assert dryrun.should_skip("gemma3-1b", "long_500k") is None


def test_gemma3_published_width_flops_near_model_flops():
    """chip_smoke's full-width plan, K=2 clients x one 1024-token row at
    bf16: the counted matmul and attention FLOPs against 6ND, without
    rematerialisation (``full`` adds a forward of the blocks:
    ``test_torch_remat.py``)."""
    cfg = configs.ARCHS["gemma3-1b"]
    shape = configs.InputShape("lm_full", 1024, 2, "train")
    plan = dryrun.make_plan(cfg, shape, 2, 1, "bf16")
    cost, _ = dryrun.trace_plan(plan, device="cpu", remat="none")
    ratio = cost.flops / roofline.model_flops(cfg, plan.shape)
    assert 1.0 <= ratio <= 1.2, ratio
    # bf16 params and int8 masks for two clients, and a batch
    n = roofline.total_params(cfg)
    assert 2 * 3 * n <= cost.argument_bytes <= 2 * 3 * n * 1.01
    assert cost.argument_bytes < cost.peak_live_bytes < dryrun.DATA_SHEET_MEMORY


def test_dryrun_refuses_mesh_flags_with_reasons(capsys):
    """--unroll stays refused, and --remat takes the reference's three
    values only; the mesh flags now plan the reference's meshes, and
    refuse the single-card plan's flags."""
    for argv, reason in ((["--unroll"], "eagerly"),
                         (["--remat", "bogus"], "invalid choice"),
                         (["--multi-pod", "--clients", "4"], "plan_for")):
        with pytest.raises(SystemExit):
            dryrun.parse_args(argv)
        assert reason in capsys.readouterr().err
    assert dryrun.parse_args([]).remat == "full"
    assert dryrun.parse_args(["--remat", "dots"]).remat == "dots"
    for argv, meshes in (([], [None]), (["--multi-pod"], [True]),
                         (["--both-meshes"], [False, True])):
        assert dryrun.parse_args(argv).meshes == meshes
    # a mesh larger than the world (no torchrun here: a world of one) is
    # refused with the torchrun line that gives it one, before any world
    with pytest.raises(SystemExit) as refused:
        train.main(["simulate", "--scale", "--mesh-shape", "8x1", "--device",
                    "cpu"])
    assert "torchrun --nproc_per_node 8" in str(refused.value)
    import torch.distributed as dist
    assert not dist.is_initialized()
    for argv, reason in ((["--scale", "--mesh-shape", "8"], "DATAxMODEL"),
                         (["--scale", "--mesh-shape", "2x0"], "DATAxMODEL"),
                         (["--mesh-shape", "2x1"], "require(s) --scale")):
        with pytest.raises(SystemExit):
            train.parse_args(["simulate"] + argv)
        assert reason in capsys.readouterr().err


def test_dryrun_refuses_missing_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k", "--out",
                     str(tmp_path)])
    assert dryrun.device_memory()[0] == 80 * 2 ** 30


def test_gossip_ppermute_fails_the_run(tmp_path):
    """``--gossip ppermute`` (the ring gossip) traces: the record is ``ok``,
    its analytic counts are the reference's (parameters, ``model_flops``),
    its collective term is 0 on one card, as for ``einsum``, and the fake
    trace's counts equal the same ppermute step run for real."""
    dryrun.main(["--smoke", "--device", "cpu", "--arch", "gemma3-1b",
                 "--shape", "train_4k", "--gossip", "ppermute", "--out",
                 str(tmp_path)])
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert rec["status"] == "ok" and rec["gossip"] == "ppermute", rec
    assert rec["tag"].endswith("__ppermute")
    assert rec["aten_ops"].get("aten.roll", 0) > 0
    assert rec["coll_bytes_per_device"] == 0.0
    assert rec["collectives"] == {"total_GB": 0.0, "counts": {}}
    cfg, ref_cfg = (configs.SMOKE_ARCHS["gemma3-1b"],
                    ref_configs.SMOKE_ARCHS["gemma3-1b"])
    assert rec["total_params"] == ref_roofline.total_params(ref_cfg)
    shape = dataclasses.replace(configs.INPUT_SHAPES["train_4k"],
                                seq_len=rec["seq_len"], global_batch=2)
    ref_shape = dataclasses.replace(ref_configs.INPUT_SHAPES["train_4k"],
                                    seq_len=rec["seq_len"], global_batch=2)
    mf = ref_roofline.model_flops(ref_cfg, ref_shape)
    assert roofline.model_flops(cfg, shape) == mf
    assert math.isclose(rec["roofline"]["useful_ratio"],
                        mf / rec["cost"]["flops"], abs_tol=5e-4)
    plan = dryrun.make_plan(cfg, shape, 2, 1, "bf16")
    fake, _ = dryrun.trace_plan(plan, "ppermute", device="cpu")
    step, specs = dryrun.step_and_specs(bind(cfg), plan, "ppermute")
    args = dryrun.materialize(specs, cfg.vocab, "cpu",
                              torch.Generator().manual_seed(0))
    _, real = step_cost(step, *args)
    assert dataclasses.asdict(fake) == dataclasses.asdict(real)
    assert rec["cost"]["flops"] == fake.flops


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


REF_RECORD = {  # the reference's artifact fields, as its dry run writes them
    "arch": "qwen3-8b", "shape": "train_4k", "mesh": "pod16x16",
    "gossip": "einsum", "tag": "qwen3-8b__train_4k__pod16x16",
    "unroll": True, "status": "ok", "chips": 256, "n_clients": 16,
    "per_client_batch": 16, "compile_s": 41.7,
    "memory": {"argument_size_in_bytes": 3_500_000_000},
    "cost": {"flops": 2.4e14, "bytes accessed": 1.1e12},
    "collectives": {"total_GB": 4.2, "counts": {"all-reduce": 9,
                                                "all-gather": 30,
                                                "collective-permute": 2}},
    "coll_bytes_per_device": 4.2e9,
}


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    """Published-width port records whose K x rows is the shape's own
    batch, so the reference's report prices the batch that was traced;
    and a skipped one."""
    out = str(tmp_path_factory.mktemp("torch_dryrun"))
    return [dryrun.run_one("gemma3-1b", "long_500k", out_dir=out,
                           verbose=False, n_clients=1, per_client_batch=1,
                           device="cpu"),
            dryrun.run_one("mamba2-1.3b", "decode_32k", out_dir=out,
                           verbose=False, n_clients=2, per_client_batch=64,
                           device="cpu"),
            dryrun.run_one("qwen3-8b", "long_500k", out_dir=out,
                           verbose=False)]


def test_tables_render_the_same_in_both_packages(port_records,
                                                 reference_constants,
                                                 tmp_path):
    records = port_records + [REF_RECORD]
    for mesh in ("h100x1", "pod16x16"):
        assert report.dryrun_table(records, mesh) == \
            ref_report.dryrun_table(records, mesh)
        assert report.roofline_table(records, mesh) == \
            ref_report.roofline_table(records, mesh)
    assert report.dryrun_table(records, "h100x1").count("\n") == 4
    for rec in records:
        (tmp_path / f"{rec['tag']}.json").write_text(json.dumps(rec))
    tags = lambda rs: sorted(r["tag"] for r in rs)  # noqa: E731
    assert tags(report.load_records(str(tmp_path))) == tags(
        ref_report.load_records(str(tmp_path), prefer_unroll=False)) == tags(
        records)


def test_port_roofline_prices_the_traced_batch(tmp_path):
    """At the default plan (K=2 clients x 1 row) the port prices the two
    rows it traced; the reference's report prices the shape's own 128."""
    rec = dryrun.run_one("mamba2-1.3b", "decode_32k", out_dir=str(tmp_path),
                         verbose=False, device="cpu")
    cfg = configs.ARCHS["mamba2-1.3b"]
    traced = dataclasses.replace(configs.INPUT_SHAPES["decode_32k"],
                                 global_batch=2)
    want = roofline.model_flops(cfg, traced) / rec["cost"]["flops"]
    assert report.fresh_report(rec).useful_ratio == want
    assert rec["roofline"]["useful_ratio"] == round(want, 3)
    assert ref_report.fresh_report(rec).useful_ratio == pytest.approx(
        64 * want, rel=1e-12)


def test_port_mesh_records_table_apart_from_the_reference(tmp_path):
    """A port mesh record (``"tp": false``: whole clients a rank) is
    tabled under a heading of its own, never in the reference's table of
    the same mesh, and both load from one directory."""
    port = {**REF_RECORD, "tp": False, "unroll": False}
    assert report.table_mesh(REF_RECORD) == "pod16x16"
    assert report.table_mesh(port) == "pod16x16" + report.REPLICATED
    only_ref = report.dryrun_table([REF_RECORD], "pod16x16")
    assert report.dryrun_table([REF_RECORD, port], "pod16x16") == only_ref
    assert report.dryrun_table([port], report.table_mesh(port)) == \
        only_ref
    for i, rec in enumerate((REF_RECORD, port)):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    assert len(report.load_records(str(tmp_path))) == 2


def test_port_tp_records_table_beside_the_reference(tmp_path):
    """A port mesh record that splits its clients over 'model' (``"tp":
    true``) is tabled under the reference's mesh heading, its row beside
    the reference's row of the same arch and shape and marked as the
    port's, and both load from one directory under one tag."""
    port = {**REF_RECORD, "tp": True, "replicated": [], "unroll": False,
            "cost": {"flops": 1.5e13, "bytes accessed": 9.0e10},
            "peak_live_bytes": 2 ** 34, "device_memory_bytes": 80 * 2 ** 30,
            "dtype": "bf16", "trace_s": 12.0, "fits": True}
    assert report.table_mesh(port) == "pod16x16"
    for i, rec in enumerate((REF_RECORD, port)):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    records = report.load_records(str(tmp_path))
    assert len(records) == 2
    table = report.dryrun_table(records, "pod16x16").splitlines()
    rows = [r for r in table if r.startswith("| qwen3-8b")]
    assert [r.split(" | ")[0] for r in rows] == [
        "| qwen3-8b", "| qwen3-8b" + report.PORT_ROW]
    assert " | 240000.0 | " in rows[0] and " | 15000.0 | " in rows[1]
    assert report.roofline_table(records, "pod16x16").count(
        report.PORT_ROW) == 1
    fit = report.fit_table(records, "pod16x16")
    assert fit.count("| qwen3-8b") == 1 and report.PORT_ROW in fit
