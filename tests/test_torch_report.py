"""The port's report side against the JAX package's, on the same records.

Records are made with the JAX ``RunRecord`` (and the port's own monitor,
for ``h100_sxm`` records) from a numpy seed and saved; both packages load
the same files. Every check runs the JAX function and its port on those
inputs: tables, series, findings and post-processed records agree within
1e-12 relative, ``render_text``, ``index.html``, ``findings.json`` and the
badges are equal as strings or bytes, and the ``talp`` CLI's exit codes
and summaries are equal. The cases mirror ``tests/test_folder.py``,
``tests/test_scaling_tables.py``, ``tests/test_regression_attribution.py``
and ``tests/test_cli_roundtrip.py``.

One divergence is pinned, not a port fault: the JAX report raises
``KeyError`` on a record whose ``hardware`` is ``h100_sxm`` (its
``get_target`` knows the TPU targets only), where the port renders it.
"""

import dataclasses
import json
import math
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import factors as FJ  # noqa: E402
from repro.core import folder as FDJ  # noqa: E402
from repro.core import hardware as HJ  # noqa: E402
from repro.core import regression as RJ  # noqa: E402
from repro.core import report as REPJ  # noqa: E402
from repro.core import scaling as SJ  # noqa: E402
from repro.core import timeseries as TSJ  # noqa: E402
from repro.core.pages import main as main_j  # noqa: E402
from repro.core.records import (  # noqa: E402
    GLOBAL_REGION,
    ComputationCounters,
    RegionCounters,
    RegionMeasurements,
    RegionRecord,
    ResourceConfig,
    RunRecord,
)
from repro_torch.core import factors as FT  # noqa: E402
from repro_torch.core import folder as FDT  # noqa: E402
from repro_torch.core import hardware as HT  # noqa: E402
from repro_torch.core import regression as RT  # noqa: E402
from repro_torch.core import report as REPT  # noqa: E402
from repro_torch.core import scaling as ST  # noqa: E402
from repro_torch.core import timeseries as TST  # noqa: E402
from repro_torch.core.pages import main as main_t  # noqa: E402
from repro_torch.core.records import RunRecord as RunRecordT  # noqa: E402

REL = 1e-12


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def assert_close(a, b, path="$"):
    """Equal structures; floats within REL relative (NaN equals NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), f"{path}: keys {a} vs {b}"
        for k in a:
            assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), f"{path}: {a} vs {b}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, str) and b is not None:
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), f"{path}: {a} vs {b}"
        else:
            assert abs(a - b) <= REL * max(abs(a), abs(b)), f"{path}: {a} vs {b}"
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def load_both(paths):
    paths = [str(p) for p in paths]
    return [RunRecord.load(p) for p in paths], [RunRecordT.load(p) for p in paths]


def findings_json(findings):
    return [
        {**{f.name: getattr(fd, f.name) for f in dataclasses.fields(fd)
            if f.name != "computations"},
         "computations": [c.to_json() for c in fd.computations],
         "describe": fd.describe()}
        for fd in findings
    ]


def tree_bytes(root):
    """Every file under ``root`` by relative path, as bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def run_cli(capsys, argv_j, argv_t, strip=()):
    """Both packages' ``main`` on their argv; returns (rc, stdout) pairs with
    each side's own paths in ``strip`` replaced by a placeholder."""
    rc_j = main_j(argv_j)
    out_j = capsys.readouterr().out
    rc_t = main_t(argv_t)
    out_t = capsys.readouterr().out
    for pj, pt in strip:
        out_j, out_t = out_j.replace(str(pj), "<out>"), out_t.replace(str(pt), "<out>")
    return (rc_j, out_j), (rc_t, out_t)


# ---------------------------------------------------------------------------
# hardware: the JAX targets as data, H100 the default
# ---------------------------------------------------------------------------


def test_get_target_matches_jax_specs():
    for name in ("tpu_v5e", "tpu_v5p"):
        assert dataclasses.asdict(HT.get_target(name)) == dataclasses.asdict(HJ.get_target(name))
    assert HT.get_target(None) is HT.H100_SXM is HT.DEFAULT_TARGET
    with pytest.raises(KeyError, match="unknown hardware target"):
        HT.get_target("nope")


@pytest.mark.parametrize("hardware", ["tpu_v5e", "tpu_v5p"])
def test_absolute_factors_match_jax_on_a_jax_record(tmp_path, hardware):
    rng = np.random.default_rng(3)
    run = RunRecord("a", ResourceConfig(num_hosts=2, devices_per_host=4,
                                        mesh={"data": 4, "model": 2}, num_pods=1),
                    "2026-07-01T00:00:00", hardware=hardware)
    run.regions[GLOBAL_REGION] = RegionRecord(
        name=GLOBAL_REGION,
        measurements=RegionMeasurements(elapsed_s=float(rng.uniform(5, 9)), num_steps=10,
                                        device_time_s=float(rng.uniform(2, 5)),
                                        data_lb=float(rng.uniform(0.6, 1))),
        counters=RegionCounters(useful_flops=float(rng.uniform(1e14, 1e15)),
                                hlo_bytes=float(rng.uniform(1e12, 1e13)),
                                collective_bytes_ici=float(rng.uniform(1e10, 1e11)),
                                collective_bytes_dcn=float(rng.uniform(1e8, 1e9)),
                                model_flops=float(rng.uniform(1e14, 1e15))))
    run.save(tmp_path / "r.json")
    (rj,), (rt,) = load_both([tmp_path / "r.json"])
    assert rt.hardware == hardware
    for ov in (0.0, 0.5):
        pj = FJ.absolute_factors(rj.global_region, rj.resources, rj.hardware, ov)
        pt = FT.absolute_factors(rt.global_region, rt.resources, rt.hardware, ov)
        assert_close(pj, pt)


# ---------------------------------------------------------------------------
# folder handling (tests/test_folder.py)
# ---------------------------------------------------------------------------


def make_run(app="app", ts="2026-07-13T10:00:00", elapsed=1.0):
    r = RunRecord(app_name=app, resources=ResourceConfig(num_hosts=1, devices_per_host=4),
                  timestamp=ts)
    r.regions[GLOBAL_REGION] = RegionRecord(
        name=GLOBAL_REGION,
        measurements=RegionMeasurements(elapsed_s=elapsed, num_steps=5),
        counters=RegionCounters(useful_flops=1e9),
    )
    return r


def twin(tmp_path, build):
    """Build one folder tree, then copy it: one copy per package."""
    build(tmp_path / "j")
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    return tmp_path / "j", tmp_path / "t"


def test_merge_history_current_pipeline_wins(tmp_path):
    def build(root):
        make_run(app="current", elapsed=2.0).save(root / "cur" / "exp" / "run.json")
        make_run(app="historic", elapsed=9.0).save(root / "hist" / "exp" / "run.json")
        make_run(app="historic").save(root / "hist" / "exp" / "older.json")

    j, t = twin(tmp_path, build)
    got_j = FDJ.merge_history(str(j / "hist"), str(j / "cur"))
    got_t = FDT.merge_history(str(t / "hist"), str(t / "cur"))
    assert got_j == got_t == 1
    assert tree_bytes(j) == tree_bytes(t)
    assert RunRecordT.load(t / "cur" / "exp" / "run.json").app_name == "current"
    assert FDJ.merge_history(str(j / "hist"), str(j / "cur")) == 0
    assert FDT.merge_history(str(t / "hist"), str(t / "cur")) == 0


def test_merge_history_preserves_nested_experiment_dirs(tmp_path):
    def build(root):
        os.makedirs(root / "cur", exist_ok=True)
        make_run().save(root / "hist" / "mesh1" / "strong" / "a.json")
        make_run().save(root / "hist" / "mesh1" / "weak" / "b.json")
        make_run().save(root / "hist" / "mesh2" / "c.json")
        make_run().save(root / "hist" / "root.json")

    j, t = twin(tmp_path, build)
    assert FDJ.merge_history(str(j / "hist"), str(j / "cur")) == 4
    assert FDT.merge_history(str(t / "hist"), str(t / "cur")) == 4
    ej, et = FDJ.scan(str(j / "cur")), FDT.scan(str(t / "cur"))
    assert [e.rel_path for e in ej] == [e.rel_path for e in et]
    assert [e.name for e in ej] == [e.name for e in et]
    assert_close([[r.to_json() for r in e.runs] for e in ej],
                 [[r.to_json() for r in e.runs] for e in et])
    for root, merge in ((j, FDJ.merge_history), (t, FDT.merge_history)):
        (root / "hist" / "mesh2" / "notes.txt").write_text("ignore me")
        assert merge(str(root / "hist"), str(root / "cur")) == 0


def test_scan_skips_unreadable_json_but_keeps_experiment(tmp_path, capsys):
    make_run().save(tmp_path / "exp" / "good.json")
    (tmp_path / "exp" / "broken.json").write_text("{definitely not json")
    too_new = make_run().to_json()
    too_new["schema_version"] = 99
    (tmp_path / "exp" / "future.json").write_text(json.dumps(too_new))

    ej = FDJ.scan(str(tmp_path))
    out_j = capsys.readouterr().out
    et = FDT.scan(str(tmp_path))
    out_t = capsys.readouterr().out
    assert [[r.app_name for r in e.runs] for e in et] == [["app"]]
    assert [[r.to_json() for r in e.runs] for e in ej] == [[r.to_json() for r in e.runs] for e in et]
    assert out_j == out_t and out_t.count("skipping unreadable run") == 2


def test_scan_drops_experiment_with_only_unreadable_json(tmp_path):
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp" / "broken.json").write_text("nope")
    assert FDJ.scan(str(tmp_path)) == FDT.scan(str(tmp_path)) == []


def test_add_metadata_skips_unreadable_json(tmp_path):
    def build(root):
        make_run().save(root / "exp" / "good.json")
        (root / "exp" / "broken.json").write_text("{]")

    j, t = twin(tmp_path, build)
    assert FDJ.add_metadata(str(j), {"ci": "yes"}) == FDT.add_metadata(str(t), {"ci": "yes"}) == 1
    assert tree_bytes(j) == tree_bytes(t)
    assert (t / "exp" / "broken.json").read_text() == "{]"


# ---------------------------------------------------------------------------
# scaling tables (tests/test_scaling_tables.py): weak, strong, comparison
# ---------------------------------------------------------------------------


def table_run(hosts, devs, flops, ts="2026-07-13T10:00:00", device_s=10.0):
    r = RunRecord(app_name="a", resources=ResourceConfig(num_hosts=hosts, devices_per_host=devs),
                  timestamp=ts)
    r.regions[GLOBAL_REGION] = RegionRecord(
        name=GLOBAL_REGION,
        measurements=RegionMeasurements(elapsed_s=device_s * 1.1, num_steps=10,
                                        device_time_s=device_s),
        counters=RegionCounters(useful_flops=flops, hlo_bytes=flops / 100,
                                collective_bytes_ici=flops / 1000),
    )
    return r


def saved(tmp_path, runs, sub="exp"):
    paths = []
    for i, r in enumerate(runs):
        p = tmp_path / sub / f"run_{i}.json"
        r.save(p)
        paths.append(p)
    return load_both(paths)


def seeded_folder(kind, seed=0):
    """A weak, strong or comparison folder: seeded counters and times."""
    rng = np.random.default_rng(seed)
    layouts = {"weak": [(1, 4), (2, 4), (4, 4)], "strong": [(1, 4), (2, 4), (4, 4)],
               "comparison": [(1, 8), (2, 4), (4, 2)]}[kind]
    base = float(rng.uniform(1e12, 2e12))
    runs = []
    for i, (h, d) in enumerate(layouts):
        n = h * d
        # weak: FLOPs per device within the 20% rule; else total FLOPs drift
        flops = base * float(rng.uniform(1.0, 1.15)) * (n / 4 if kind == "weak" else 1.0)
        runs.append(table_run(h, d, flops, ts=f"2026-07-0{i + 1}T00:00:00",
                              device_s=float(rng.uniform(5, 15))))
    return runs


def both_tables(runs_j, runs_t, **kw):
    tj, tt = SJ.build_table(runs_j, **kw), ST.build_table(runs_t, **kw)
    assert (tj is None) == (tt is None)
    if tj is not None:
        assert_close(tj.to_json(), tt.to_json())
        assert SJ.render_text(tj) == ST.render_text(tt)
        assert REPJ.table_html(tj) == REPT.table_html(tt)
    return tj, tt


@pytest.mark.parametrize("kind", ["weak", "strong", "comparison"])
def test_seeded_folders_build_equal_tables(tmp_path, kind):
    runs_j, runs_t = saved(tmp_path, seeded_folder(kind, seed=len(kind)))
    mode = "comparison" if kind == "comparison" else None
    for overlap in (0.0, 0.3):
        _, tt = both_tables(runs_j, runs_t, overlap_fraction=overlap, mode=mode)
        assert tt.mode == {"weak": FT.WEAK, "strong": FT.STRONG}.get(kind, "comparison")
        assert [c.is_reference for c in tt.columns] == [True, False, False]


def test_latest_per_config_wins(tmp_path):
    runs_j, runs_t = saved(tmp_path, [
        table_run(1, 4, 1e12, ts="2026-07-01T00:00:00"),
        table_run(1, 4, 2e12, ts="2026-07-02T00:00:00"),
        table_run(2, 4, 1e12),
    ])
    lj, lt = SJ.latest_per_config(runs_j), ST.latest_per_config(runs_t)
    assert [r.to_json() for r in lj] == [r.to_json() for r in lt]
    assert len(lt) == 2 and lt[0].regions[GLOBAL_REGION].counters.useful_flops == 2e12


def test_reference_is_least_resources(tmp_path):
    runs_j, runs_t = saved(tmp_path, [table_run(4, 4, 1e12), table_run(1, 4, 1e12),
                                      table_run(2, 4, 1e12)])
    _, t = both_tables(runs_j, runs_t)
    assert t.columns[0].is_reference and [c.label for c in t.columns] == ["1x4", "2x4", "4x4"]


def test_reference_column_has_identity_scalability(tmp_path):
    runs_j, runs_t = saved(tmp_path, [table_run(1, 4, 1e12), table_run(2, 4, 1.25e12)])
    _, t = both_tables(runs_j, runs_t)
    assert t.columns[0].pop[FT.COMP_SCALABILITY] == pytest.approx(1.0)
    assert t.columns[1].pop[FT.FLOP_SCALING] == pytest.approx(0.8)
    assert t.mode == FT.STRONG


def test_weak_scaling_uses_per_device_instructions(tmp_path):
    runs_j, runs_t = saved(tmp_path, [table_run(1, 4, 1e12), table_run(2, 4, 2.1e12)])
    _, t = both_tables(runs_j, runs_t)
    assert t.mode == FT.WEAK
    assert t.columns[1].pop[FT.FLOP_SCALING] == pytest.approx(2.5e11 / 2.625e11, rel=1e-6)


def test_global_efficiency_composes(tmp_path):
    runs_j, runs_t = saved(tmp_path, [table_run(1, 4, 1e12), table_run(2, 4, 1e12)])
    _, t = both_tables(runs_j, runs_t)
    for c in t.columns:
        assert c.pop[FT.GLOBAL_EFF] == pytest.approx(c.pop[FT.PARALLEL_EFF] * c.pop[FT.COMP_SCALABILITY])
        assert FT.validate_pop(c.pop) == []


def test_missing_region_returns_none(tmp_path):
    runs_j, runs_t = saved(tmp_path, [table_run(1, 4, 1e12)])
    assert both_tables(runs_j, runs_t, region="nope") == (None, None)


def test_table_is_order_invariant(tmp_path):
    runs_j, runs_t = saved(tmp_path, [table_run(2, 4, 1e12), table_run(1, 4, 1e12),
                                      table_run(4, 4, 1e12)])
    _, a = both_tables(runs_j, runs_t)
    _, b = both_tables(list(reversed(runs_j)), list(reversed(runs_t)))
    assert a.to_json() == b.to_json()


# ---------------------------------------------------------------------------
# time series and regression findings (tests/test_regression_attribution.py)
# ---------------------------------------------------------------------------

HOT = "while_body.all_gather_fusion.3"


def reg_run(ts, elapsed, device_time, coll_ici, hot_coll, hot_hbm=1e9):
    run = RunRecord("app", ResourceConfig(num_hosts=1, devices_per_host=8), ts)
    reg = RegionRecord(
        name="timestep",
        measurements=RegionMeasurements(elapsed_s=elapsed, num_steps=10,
                                        device_time_s=device_time),
        counters=RegionCounters(useful_flops=1e10, hlo_bytes=1e9 + hot_hbm,
                                collective_bytes_ici=coll_ici),
        computations={
            HOT: ComputationCounters(name=HOT, kind="while_body", multiplicity=24, flops=1e9,
                                     hbm_bytes=hot_hbm, collective_operand_bytes=hot_coll),
            "entry": ComputationCounters(name="entry", kind="entry", flops=9e9, hbm_bytes=1e9,
                                         collective_operand_bytes=1e7),
        },
    )
    reg.pop = FJ.compute_pop(reg, run.resources, "tpu_v5e")
    run.regions["timestep"] = reg
    return run


def both_findings(tmp_path, runs):
    runs_j, runs_t = saved(tmp_path, runs)
    sj, st = TSJ.build_series(runs_j), TST.build_series(runs_t)
    assert_close([c.to_json() for c in sj], [c.to_json() for c in st])
    fj = RJ.detect(sj[0].regions["timestep"], sj[0].label)
    ft = RT.detect(st[0].regions["timestep"], st[0].label)
    assert_close(findings_json(fj), findings_json(ft))
    return ft


REGRESSING = [
    reg_run("2026-07-01T00:00:00", 1.0, 0.95, coll_ici=2e8, hot_coll=1.9e8),
    reg_run("2026-07-02T00:00:00", 1.4, 1.30, coll_ici=2e9, hot_coll=1.99e9),
]


def test_localized_collective_regression_names_computation(tmp_path):
    (fd,) = both_findings(tmp_path, REGRESSING)
    assert fd.kind == "regression"
    assert FT.COMM_EFF in fd.explanation or FT.ICI_COMM_EFF in fd.explanation
    assert fd.computations[0].name == HOT
    assert fd.computations[0].metric == "collective_operand_bytes"
    assert HOT in fd.describe()


def test_records_without_breakdown_yield_plain_findings(tmp_path):
    runs = [reg_run("2026-07-01T00:00:00", 1.0, 0.95, coll_ici=2e8, hot_coll=1.9e8),
            reg_run("2026-07-02T00:00:00", 1.4, 1.30, coll_ici=2e9, hot_coll=1.99e9)]
    for run in runs:
        run.regions["timestep"].computations = {}
    (fd,) = both_findings(tmp_path, runs)
    assert fd.computations == [] and "explained by" in fd.describe()


def test_seeded_history_findings_match(tmp_path):
    """A seeded history of eight runs with random slowdowns and counter
    moves: every series point and every finding agree."""
    rng = np.random.default_rng(11)
    runs = []
    for i in range(8):
        e = float(rng.uniform(0.8, 1.6))
        runs.append(reg_run(f"2026-07-{i + 1:02d}T00:00:00", e, e * float(rng.uniform(0.7, 0.99)),
                            coll_ici=float(rng.uniform(1e8, 3e9)),
                            hot_coll=float(rng.uniform(1e7, 1e9)),
                            hot_hbm=float(rng.uniform(5e8, 5e9))))
    found = both_findings(tmp_path, runs)
    assert found  # the seed moves elapsed time beyond the 5% threshold


CMP = [
    # (before, after, metric): explain_computations's cases
    ({HOT: {"flops": 1e9, "hbm_bytes": 1e9, "collective_operand_bytes": 0.0},
      "entry": {"flops": 9e9, "hbm_bytes": 1e9, "collective_operand_bytes": 0.0}},
     {HOT: {"flops": 1e9, "hbm_bytes": 4e9, "collective_operand_bytes": 0.0},
      "entry": {"flops": 9e9, "hbm_bytes": 1e9, "collective_operand_bytes": 0.0}},
     None),
    ({"big": {"flops": 0.0, "hbm_bytes": 1e10, "collective_operand_bytes": 0.0},
      "tiny": {"flops": 0.0, "hbm_bytes": 1e3, "collective_operand_bytes": 0.0}},
     {"big": {"flops": 0.0, "hbm_bytes": 2e10, "collective_operand_bytes": 0.0},
      "tiny": {"flops": 0.0, "hbm_bytes": 1e6, "collective_operand_bytes": 0.0}},
     "hbm_bytes"),
    ({"entry": {"flops": 1e9, "hbm_bytes": 1e9, "collective_operand_bytes": 0.0}},
     {"entry": {"flops": 1e9, "hbm_bytes": 1e9, "collective_operand_bytes": 0.0},
      "all_gather.9": {"flops": 0.0, "hbm_bytes": 2e9, "collective_operand_bytes": 5e8}},
     "collective_operand_bytes"),
    ({"big": {"flops": 0.0, "hbm_bytes": 1e10, "collective_operand_bytes": 0.0},
      "small": {"flops": 0.0, "hbm_bytes": 1e9, "collective_operand_bytes": 0.0}},
     {"big": {"flops": 0.0, "hbm_bytes": 1e10, "collective_operand_bytes": 0.0},
      "small": {"flops": 0.0, "hbm_bytes": 1e9, "collective_operand_bytes": 0.0},
      "riser": {"flops": 0.0, "hbm_bytes": 9e8, "collective_operand_bytes": 0.0}},
     "hbm_bytes"),
    ({}, {"entry": {"flops": 1e9, "hbm_bytes": 1e9, "collective_operand_bytes": 0.0}}, None),
]


@pytest.mark.parametrize("case", range(len(CMP)),
                         ids=["best_metric", "share_not_relative", "new", "below_cut", "one_sided"])
def test_explain_computations_matches_jax(case):
    before, after, metric = CMP[case]
    sj = RJ.explain_computations(before, after, metric=metric)
    st = RT.explain_computations(before, after, metric=metric)
    assert [s.to_json() for s in sj] == [s.to_json() for s in st]
    assert [s.describe() for s in sj] == [s.describe() for s in st]
    names = [s.name for s in st]
    want = {0: [HOT], 1: ["big"], 2: ["all_gather.9"], 3: [], 4: []}[case]
    assert names == want
    if case == 2:
        assert math.isinf(st[0].rel_change) and st[0].to_json()["rel_change"] is None
    # the one-sided rule holds both ways round
    if case == 4:
        assert RT.explain_computations(after, before) == []


def test_timeseries_exposes_computation_series(tmp_path):
    runs_j, runs_t = saved(tmp_path, [
        reg_run("2026-07-01T00:00:00", 1.0, 0.95, coll_ici=2e8, hot_coll=1e8, hot_hbm=1e9),
        reg_run("2026-07-02T00:00:00", 1.0, 0.95, coll_ici=2e8, hot_coll=1e8, hot_hbm=3e9),
    ])
    rj = TSJ.build_series(runs_j)[0].regions["timestep"]
    rt = TST.build_series(runs_t)[0].regions["timestep"]
    for m in ("hbm_bytes", "flops", "collective_operand_bytes"):
        assert rj.computation_series(m) == rt.computation_series(m)
        assert rj.top_computation_names(2, m) == rt.top_computation_names(2, m)
    assert rt.computation_series("hbm_bytes")[HOT] == [1e9, 3e9]
    for rs in (rj, rt):
        rs.points[0].computations.pop(HOT)
    gj, gt = rj.computation_series("hbm_bytes")[HOT], rt.computation_series("hbm_bytes")[HOT]
    assert math.isnan(gj[0]) and math.isnan(gt[0]) and gj[1] == gt[1] == 3e9


# ---------------------------------------------------------------------------
# the talp CLI and the site (tests/test_cli_roundtrip.py)
# ---------------------------------------------------------------------------


def _base_run(ts, commit, elapsed):
    run = RunRecord(app_name="smoke", resources=ResourceConfig(num_hosts=1, devices_per_host=8),
                    timestamp=ts, metadata={"git_commit_short": commit, "git_commit_timestamp": ts})
    reg = RegionRecord(
        name=GLOBAL_REGION,
        measurements=RegionMeasurements(elapsed_s=elapsed, num_steps=10,
                                        device_time_s=elapsed * 0.9),
        counters=RegionCounters(useful_flops=1e12, hlo_bytes=1e10, collective_bytes_ici=1e8,
                                model_flops=8e11),
    )
    reg.pop = FJ.compute_pop(reg, run.resources, run.hardware)
    run.regions[GLOBAL_REGION] = reg
    return run


def _write_v2(path, ts, commit, elapsed):
    d = _base_run(ts, commit, elapsed).to_json()
    d["schema_version"] = 2
    for rd in d["regions"].values():
        rd.pop("computations", None)
    d["metadata"]["per_computation"] = {GLOBAL_REGION: [
        {"name": "while_body.fusion.1", "kind": "while_body", "multiplicity": 24,
         "num_instructions": 30, "flops": 8e11, "dot_flops": 6e11, "hbm_bytes": 9e9,
         "collective_operand_bytes": 1e8}]}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f)


def _write_v3(path, ts, commit, elapsed):
    run = _base_run(ts, commit, elapsed)
    run.global_region.computations = {"while_body.fusion.1": ComputationCounters(
        name="while_body.fusion.1", kind="while_body", multiplicity=24, num_instructions=30,
        flops=8e11, dot_flops=6e11, hbm_bytes=9e9, collective_operand_bytes=1e8)}
    run.save(path)


@pytest.fixture()
def mixed_folder(tmp_path):
    talp = tmp_path / "talp"
    _write_v2(str(talp / "exp" / "run_0.json"), "2026-07-10T00:00:00", "c00", 1.00)
    _write_v2(str(talp / "exp" / "run_1.json"), "2026-07-11T00:00:00", "c01", 1.02)
    _write_v3(str(talp / "exp" / "run_2.json"), "2026-07-12T00:00:00", "c02", 1.01)
    return talp


def ci_report_both(capsys, folder, site_j, site_t, *extra):
    (rc_j, out_j), (rc_t, out_t) = run_cli(
        capsys, ["ci-report", "-i", str(folder), "-o", str(site_j), *extra],
        ["ci-report", "-i", str(folder), "-o", str(site_t), *extra], strip=[(site_j, site_t)])
    assert rc_j == rc_t == 0 and out_j == out_t
    assert tree_bytes(site_j) == tree_bytes(site_t)  # index.html, findings.json, badges
    return (site_t / "index.html").read_text(), out_t


@pytest.mark.parametrize("top", ["4", "0"])
def test_ci_report_roundtrip_over_v2_and_v3_records(mixed_folder, tmp_path, capsys, top):
    html, _ = ci_report_both(capsys, mixed_folder, tmp_path / "sj", tmp_path / "st",
                             "--top-computations", top, "--print-tables")
    assert "Scaling efficiency" in html
    assert ("HLO computation breakdown" in html) == (top != "0")
    assert ("while_body.fusion.1" in html) == (top != "0")
    badges = [n for n in os.listdir(tmp_path / "st") if n.startswith("badge_")]
    assert badges and "<svg" in (tmp_path / "st" / badges[0]).read_text()


def test_badge_cli_from_mixed_folder(mixed_folder, tmp_path, capsys):
    bj, bt = tmp_path / "bj.svg", tmp_path / "bt.svg"
    (rc_j, out_j), (rc_t, out_t) = run_cli(
        capsys, ["badge", "-i", str(mixed_folder), "-o", str(bj)],
        ["badge", "-i", str(mixed_folder), "-o", str(bt)], strip=[(bj, bt)])
    assert rc_j == rc_t == 0 and out_j == out_t
    assert bj.read_bytes() == bt.read_bytes() and b"<svg" in bt.read_bytes()
    for v in (None, 0.95, 0.7, 0.3):
        assert REPJ.badge_svg("parallel eff", v) == REPT.badge_svg("parallel eff", v)


def test_validate_flags_a_planted_factor_violation(mixed_folder, tmp_path, capsys):
    (rc_j, out_j), (rc_t, out_t) = run_cli(capsys, ["validate", "-i", str(mixed_folder)],
                                           ["validate", "-i", str(mixed_folder)])
    assert rc_j == rc_t == 0 and out_j == out_t and "3 runs checked, 0 violations" in out_t
    path = mixed_folder / "exp" / "run_2.json"
    d = json.loads(path.read_text())
    d["regions"][GLOBAL_REGION]["pop"]["parallel_efficiency"] *= 0.5
    path.write_text(json.dumps(d))
    (rc_j, out_j), (rc_t, out_t) = run_cli(capsys, ["validate", "-i", str(mixed_folder)],
                                           ["validate", "-i", str(mixed_folder)])
    assert rc_j == rc_t == 1 and out_j == out_t and "2 violations" in out_t


def test_metadata_and_merge_history_cli(mixed_folder, tmp_path, capsys):
    """``metadata`` (git metadata plus ``--extra``) and ``merge-history``,
    on one copy of the folder each."""
    j, t = tmp_path / "j", tmp_path / "t"
    shutil.copytree(mixed_folder, j)
    shutil.copytree(mixed_folder, t)
    (rc_j, out_j), (rc_t, out_t) = run_cli(
        capsys, ["metadata", "-i", str(j), "--git-dir", str(tmp_path), "--extra", "ci=1"],
        ["metadata", "-i", str(t), "--git-dir", str(tmp_path), "--extra", "ci=1"])
    assert rc_j == rc_t == 0 and out_j == out_t
    assert tree_bytes(j) == tree_bytes(t)
    (rc_j, out_j), (rc_t, out_t) = run_cli(
        capsys, ["merge-history", "--history", str(mixed_folder), "--current", str(j / "new")],
        ["merge-history", "--history", str(mixed_folder), "--current", str(t / "new")],
        strip=[(j, t)])
    assert rc_j == rc_t == 0 and out_j == out_t and "merged 3 historic" in out_t
    (rc_j, out_j), (rc_t, out_t) = run_cli(
        capsys, ["merge-history", "--history", str(tmp_path / "none"), "--current", str(j)],
        ["merge-history", "--history", str(tmp_path / "none"), "--current", str(t)])
    assert rc_j == rc_t == 0 and out_j == out_t


def test_ci_report_without_records_exits_1(tmp_path, capsys):
    (tmp_path / "empty").mkdir()
    (rc_j, _), (rc_t, _) = run_cli(
        capsys, ["ci-report", "-i", str(tmp_path / "empty"), "-o", str(tmp_path / "sj")],
        ["ci-report", "-i", str(tmp_path / "empty"), "-o", str(tmp_path / "st")])
    assert rc_j == rc_t == 1


# ---------------------------------------------------------------------------
# the port's own h100_sxm records
# ---------------------------------------------------------------------------


def port_history(root, n=3, slow_at=1):
    """Port monitor records (``h100_sxm``) of one 1x1 experiment; run
    ``slow_at`` executes twice the FLOPs in twice the time."""
    from repro_torch.core.profile import StepProfile
    from repro_torch.core.records import ComputationCounters as CCT
    from repro_torch.core.records import ResourceConfig as RCT
    from repro_torch.session import PerfSession, SessionConfig

    rng = np.random.default_rng(5)
    for i in range(n):
        slow = 2.0 if i == slow_at else 1.0
        clock = [0.0]
        ses = PerfSession(
            SessionConfig(app_name="port", backend="monitor", clock=lambda: clock[0],
                          sync_regions=False, lb_sample_every=1, respect_env=False),
            RCT(num_hosts=1, devices_per_host=1),
            metadata={"git_commit_short": f"p{i:02d}",
                      "git_commit_timestamp": f"2026-08-{10 + i:02d}T00:00:00"})
        flops = 4e12 * slow
        ses.attach_static("train_step", StepProfile(
            flops=flops, dot_flops=flops, hbm_bytes=2e10 * slow, model_flops=3e12,
            per_computation={"aten.mm": CCT(name="aten.mm", kind="op", flops=flops,
                                            dot_flops=flops, hbm_bytes=1e10 * slow),
                             "flash_attention": CCT(name="flash_attention", kind="kernel",
                                                    flops=1e11, hbm_bytes=1e10)}))
        ses.start()
        with ses.region("train_step"):
            for _ in range(4):
                clock[0] += 0.3 * slow * float(rng.uniform(0.98, 1.02))
                ses.observe_step(tokens_per_shard=[int(rng.integers(7000, 8192))])
        run = ses.finalize(git=False)
        run.timestamp = f"2026-08-{10 + i:02d}T01:00:00"
        run.save(os.path.join(root, f"run_{i}.json"))


def test_port_renders_h100_records_the_jax_report_cannot(tmp_path, capsys):
    port_history(str(tmp_path / "talp" / "port"))
    rc = main_t(["ci-report", "-i", str(tmp_path / "talp"), "-o", str(tmp_path / "site"),
                 "--regions", "train_step", "--print-tables"])
    out = capsys.readouterr().out
    assert rc == 0 and "Global efficiency" in out
    html = (tmp_path / "site" / "index.html").read_text()
    assert "region <code>train_step</code>" in html and "aten.mm" in html
    findings = json.loads((tmp_path / "site" / "findings.json").read_text())
    assert any(f["commit"] == "p01" and f["kind"] == "regression" for f in findings)
    assert main_t(["validate", "-i", str(tmp_path / "talp")]) == 0
    # documented divergence: the JAX report knows no h100_sxm target
    (run,) = FDT.scan(str(tmp_path / "talp"))[0].runs[:1]
    assert run.hardware == "h100_sxm"
    with pytest.raises(KeyError, match="h100_sxm"):
        main_j(["ci-report", "-i", str(tmp_path / "talp"), "-o", str(tmp_path / "site_j")])


def test_mixed_folder_of_both_packages_renders(mixed_folder, tmp_path, capsys):
    port_history(str(mixed_folder / "port"))
    rc = main_t(["ci-report", "-i", str(mixed_folder), "-o", str(tmp_path / "site"),
                 "--regions", "train_step"])
    assert rc == 0
    html = (tmp_path / "site" / "index.html").read_text()
    assert "Experiment: exp" in html and "Experiment: port" in html
    exps = FDT.scan(str(mixed_folder))
    assert sorted(r.hardware for e in exps for r in e.runs) == ["h100_sxm"] * 3 + ["tpu_v5e"] * 3
    # the JAX experiment's table is the JAX package's own, to the byte
    (exp_j,) = FDJ.scan(str(mixed_folder / "exp"))
    (exp_t,) = [e for e in exps if e.rel_path == "exp"]
    assert REPJ.table_html(SJ.build_table(exp_j.runs)) == REPT.table_html(ST.build_table(exp_t.runs))
    assert REPT.table_html(ST.build_table(exp_t.runs)) in html
