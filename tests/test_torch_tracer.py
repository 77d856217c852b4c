"""The port's tracer backend against the JAX package's, and against the
port's own monitor (the paper's Tables 6/7 cross-tool check).

Both tracers are reached only through each package's
``PerfSession(SessionConfig(backend="tracer", trace_dir=...))`` and fed the
same region and step sequence on a fake clock. Their event streams are
equal to the byte; ``trace_meta.json`` differs by the port's ``hardware``
key and by the JAX profile's fields that the port's ``StepProfile`` does
not have. ``post_process`` of the JAX trace folder gives the same record in
both packages (within 1e-12 relative, timestamps aside); on the port's own
folder it labels the record ``h100_sxm`` and computes H100 factors. The
cases mirror ``tests/test_tracer_report.py`` and the tracer cases of
``tests/test_session.py``; the last runs a smoke ``TrainLoop`` on the CPU
under both backends.
"""

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import factors as FJ  # noqa: E402
from repro.core import folder as FDJ  # noqa: E402
from repro.core import report as REPJ  # noqa: E402
from repro.core import tracer as TRJ  # noqa: E402
from repro.core.pages import main as main_j  # noqa: E402
from repro.core.profile import StepProfile as StepProfileJ  # noqa: E402
from repro.core.records import ComputationCounters as CCJ  # noqa: E402
from repro.core.records import ResourceConfig as RCJ  # noqa: E402
from repro.session import PerfSession as PerfSessionJ  # noqa: E402
from repro.session import SessionConfig as SessionConfigJ  # noqa: E402
from repro_torch.core import GLOBAL_REGION, H100_SXM  # noqa: E402
from repro_torch.core import factors as FT  # noqa: E402
from repro_torch.core import folder as FDT  # noqa: E402
from repro_torch.core import report as REPT  # noqa: E402
from repro_torch.core import tracer as TRT  # noqa: E402
from repro_torch.core.pages import main as main_t  # noqa: E402
from repro_torch.core.profile import StepProfile as StepProfileT  # noqa: E402
from repro_torch.core.records import ComputationCounters as CCT  # noqa: E402
from repro_torch.core.records import ResourceConfig as RCT  # noqa: E402
from repro_torch.session import PerfSession as PerfSessionT  # noqa: E402
from repro_torch.session import SessionConfig as SessionConfigT  # noqa: E402

from test_torch_report import assert_close, tree_bytes  # noqa: E402

PKG = {
    "jax": (PerfSessionJ, SessionConfigJ, StepProfileJ, RCJ, CCJ),
    "port": (PerfSessionT, SessionConfigT, StepProfileT, RCT, CCT),
}
RES = dict(num_hosts=2, devices_per_host=4)
PROFILE = dict(num_devices=8, flops=1e12, hbm_bytes=1e10, collective_bytes_ici=1e8,
               model_flops=8e11, collective_counts={"all-reduce": 3, "all-gather": 2})


def profile(pkg, **kw):
    _, _, SP, _, CC = PKG[pkg]
    kw = {**PROFILE, **kw}
    kw["per_computation"] = {
        n: CC(name=n, **c) for n, c in kw.pop("per_computation", {}).items()}
    return SP(**kw)


def clocked_session(pkg, backend, *, resources=RES, trace_dir="", metadata=None, **kw):
    PS, SC, _, RC, _ = PKG[pkg]
    clock = [0.0]
    ses = PS(SC(app_name="x", backend=backend, clock=lambda: clock[0], sync_regions=False,
                lb_sample_every=1, respect_env=False, trace_dir=trace_dir, **kw),
             RC(**resources), metadata=metadata)
    return ses, clock


def aux(pkg, step):
    """Step observables: lists for JAX, CPU tensors for the port."""
    tok, exp = [100, 90 - step % 7], [5, 3, 2 + step % 3, 0]
    if pkg == "port":
        return dict(tokens_per_shard=torch.tensor(tok), expert_load=torch.tensor(exp))
    return dict(tokens_per_shard=tok, expert_load=exp)


def drive(pkg, backend, trace_dir="", steps=20, finalize=True, prof=None, **kw):
    """One fixed region and step sequence through either package's session."""
    ses, clock = clocked_session(pkg, backend, trace_dir=trace_dir, **kw)
    ses.attach_static("timestep", prof or profile(pkg))
    ses.start()
    with ses.region("init"):
        clock[0] += 0.5
    with ses.region("timestep"):
        for i in range(steps):
            clock[0] += 0.01 * (1 + (i % 3) / 10)
            ses.observe_step(**aux(pkg, i))
    if not finalize:
        ses.stop()
        return None
    return ses.finalize(git=False)


def record_json(run):
    d = run.to_json()
    d.pop("timestamp")
    return d


# ---------------------------------------------------------------------------
# the tracer against the JAX tracer, and against the port's monitor
# ---------------------------------------------------------------------------


def test_trace_streams_and_storage_match_jax(tmp_path):
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    drive("jax", "tracer", dj, finalize=False)
    drive("port", "tracer", dt, finalize=False)
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt)) and len(names) == 9  # 8 ranks + meta
    for n in names:
        if n.endswith(".trace"):
            assert open(os.path.join(dj, n), "rb").read() == open(os.path.join(dt, n), "rb").read()
    meta_j = json.load(open(os.path.join(dj, "trace_meta.json")))
    meta_t = json.load(open(os.path.join(dt, "trace_meta.json")))
    assert meta_t["hardware"] == "h100_sxm" and "hardware" not in meta_j
    # the JAX meta with the port's key added and the JAX-only profile fields dropped
    fields = set(StepProfileT().to_json())
    want = {"app_name": meta_j["app_name"], "resources": meta_j["resources"],
            "hardware": "h100_sxm",
            "profiles": {r: {k: v for k, v in p.items() if k in fields}
                         for r, p in meta_j["profiles"].items()}}
    assert meta_t == want
    size_j = os.path.getsize(os.path.join(dj, "trace_meta.json"))
    assert TRT.trace_storage_bytes(dt) == (TRJ.trace_storage_bytes(dj) - size_j
                                           + len(json.dumps(want)))


def test_post_process_of_a_jax_trace_matches_jax(tmp_path):
    dj = str(tmp_path / "j")
    prof = dict(per_computation={"entry": dict(kind="entry", flops=1e12, hbm_bytes=1e10)})
    drive("jax", "tracer", dj, finalize=False, prof=profile("jax", **prof))
    rj, rt = TRJ.post_process(dj), TRT.post_process(dj)
    assert rt.hardware == rj.hardware == "tpu_v5e"
    assert_close(record_json(rj), record_json(rt))
    # and through both sessions, whose finalize re-derives the factors
    sj = drive("jax", "tracer", str(tmp_path / "sj"), prof=profile("jax", **prof))
    st = drive("port", "tracer", str(tmp_path / "st"), prof=profile("port", **prof),
               hardware="tpu_v5e")
    assert_close(record_json(sj), record_json(st))


def test_port_trace_carries_h100_factors(tmp_path):
    dt = str(tmp_path / "t")
    drive("port", "tracer", dt, finalize=False)
    run = TRT.post_process(dt)
    assert run.hardware == "h100_sxm"
    reg = run.regions["timestep"]
    assert reg.pop == FT.compute_pop(reg, run.resources, H100_SXM)
    assert reg.pop[FT.MXU_UTIL] != FT.compute_pop(reg, run.resources, "tpu_v5e")[FT.MXU_UTIL]
    for r in run.regions.values():
        assert FT.validate_pop(r.pop) == []


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_monitor_and_tracer_agree_on_factors(tmp_path, pkg):
    prof = dict(per_computation={"entry": dict(kind="entry", flops=1e12, hbm_bytes=1e10)})
    a = drive(pkg, "monitor", prof=profile(pkg, **prof)).regions["timestep"]
    b = drive(pkg, "tracer", str(tmp_path / "tr"), prof=profile(pkg, **prof)).regions["timestep"]
    assert a.measurements.num_steps == b.measurements.num_steps == 20
    np.testing.assert_allclose(a.measurements.data_lb, b.measurements.data_lb, rtol=1e-6)
    np.testing.assert_allclose(a.measurements.expert_lb, b.measurements.expert_lb, rtol=1e-6)
    assert a.counters.useful_flops == b.counters.useful_flops
    for key in (FT.DATA_LB, FT.EXPERT_LB, FT.COMM_EFF, FT.ICI_COMM_EFF, FT.PARALLEL_EFF):
        np.testing.assert_allclose(a.pop[key], b.pop[key], rtol=1e-5, err_msg=key)
    assert set(a.computations) == set(b.computations)


def test_tracer_storage_scales_with_devices_and_steps(tmp_path):
    def trace_size(pkg, ndev, steps):
        d = str(tmp_path / f"{pkg}_{ndev}_{steps}")
        drive(pkg, "tracer", d, steps=steps, finalize=False,
              resources=dict(num_hosts=1, devices_per_host=ndev))
        return TRT.trace_storage_bytes(d)

    sizes = {pkg: [trace_size(pkg, 2, 10), trace_size(pkg, 4, 10), trace_size(pkg, 2, 40)]
             for pkg in ("jax", "port")}
    for s1, s2, s3 in sizes.values():
        assert s2 > 1.8 * s1 and s3 > 3.0 * s1
    # the port's meta adds the same ``hardware`` key to every trace
    deltas = {t - j for j, t in zip(sizes["jax"], sizes["port"])}
    assert len(deltas) == 1
    mon = drive("port", "monitor", steps=100)
    mon.save(tmp_path / "mon.json")
    assert os.path.getsize(tmp_path / "mon.json") < 16_000  # O(regions)


def test_tracer_postprocess_carries_computations(tmp_path):
    prof = dict(per_computation={"entry": dict(kind="entry", flops=1e12, hbm_bytes=1e10)})
    runs = {pkg: drive(pkg, "tracer", str(tmp_path / pkg), steps=3, prof=profile(pkg, **prof),
                       hardware="tpu_v5e")
            for pkg in ("jax", "port")}
    assert_close(record_json(runs["jax"]), record_json(runs["port"]))
    run = runs["port"]
    assert run.regions["timestep"].computations["entry"].flops == pytest.approx(3e12)
    assert run.regions[GLOBAL_REGION].computations["entry"].flops == pytest.approx(3e12)


# ---------------------------------------------------------------------------
# session cases (tests/test_session.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_tracer_finalize_without_start_yields_empty_valid_run(tmp_path, pkg):
    ses, _ = clocked_session(pkg, "tracer", trace_dir=str(tmp_path / "trace"),
                             hardware="tpu_v5e")
    run = ses.finalize(git=False)
    assert run is not None and run.regions[GLOBAL_REGION] is not None
    assert (FT if pkg == "port" else FJ).validate_pop(run.regions[GLOBAL_REGION].pop) == []
    if pkg == "port":
        ses_j, _ = clocked_session("jax", "tracer", trace_dir=str(tmp_path / "tj"))
        assert_close(record_json(ses_j.finalize(git=False)), record_json(run))


@pytest.mark.parametrize("backend", ["monitor", "tracer", "null"])
def test_pre_start_hooks_are_safe_on_every_backend(tmp_path, backend):
    for pkg in ("jax", "port"):
        ses, _ = clocked_session(pkg, backend, trace_dir=str(tmp_path / pkg))
        ses.observe_step({"loss": 1.0})  # before start: silently ignored
        ses.mark_device()
        ses.attach_static("r", profile(pkg))
        assert ses.backend == backend


def test_tracer_drops_pod_size_and_selects_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TALP_ENABLE", "1")
    monkeypatch.setenv("TALP_BACKEND", "tracer")
    ses = PerfSessionT(SessionConfigT(trace_dir=str(tmp_path / "t")), RCT())
    assert ses.backend == "tracer" and ses.collector.name == "tracer"
    with ses.region("r"):
        ses.observe_step(host_times=[1.0, 0.5], pod_size=1)
    run = ses.finalize(git=False)
    assert run.regions["r"].measurements.host_lb == pytest.approx(0.75)
    assert run.hardware == "h100_sxm"


# ---------------------------------------------------------------------------
# report generation from collected records (tests/test_tracer_report.py)
# ---------------------------------------------------------------------------


def make_history(pkg, root, runs=4, slow_at=None):
    """Monitor records of one 1x8 experiment; run ``slow_at`` executes
    twice the FLOPs (a remat bug) in twice the time."""
    PS, SC, SP, RC, _ = PKG[pkg]
    clock = [0.0]
    for i in range(runs):
        slow = slow_at is not None and i == slow_at
        ses = PS(SC(app_name="app", backend="monitor", clock=lambda: clock[0],
                    sync_regions=False, lb_sample_every=1, respect_env=False,
                    hardware="tpu_v5e"),
                 RC(num_hosts=1, devices_per_host=8),
                 metadata={"git_commit_short": f"c{i:02d}",
                           "git_commit_timestamp": f"2026-07-{10 + i:02d}T00:00:00"})
        ses.attach_static("timestep", profile(pkg, flops=2e12 if slow else 1e12))
        ses.start()
        with ses.region("timestep"):
            for _ in range(10):
                clock[0] += 0.02 if slow else 0.01
                ses.observe_step()
        run = ses.finalize(git=False)
        run.timestamp = f"2026-07-{10 + i:02d}T01:00:00"
        run.save(os.path.join(root, "case1", "history", f"run_{i}.json"))


def test_history_records_of_both_monitors_match(tmp_path):
    for pkg in ("jax", "port"):
        make_history(pkg, str(tmp_path / pkg), runs=3, slow_at=1)
    for i in range(3):
        rel = os.path.join("case1", "history", f"run_{i}.json")
        assert_close(json.load(open(tmp_path / "jax" / rel)), json.load(open(tmp_path / "port" / rel)))


def test_report_generation_end_to_end(tmp_path):
    make_history("jax", str(tmp_path / "talp"), runs=4, slow_at=2)
    sites = {}
    for pkg, FD, REP in (("jax", FDJ, REPJ), ("port", FDT, REPT)):
        exps = FD.scan(str(tmp_path / "talp"))
        assert len(exps) == 1
        REP.generate_report(exps, str(tmp_path / f"site_{pkg}"), regions=["timestep"])
        sites[pkg] = tree_bytes(tmp_path / f"site_{pkg}")
    assert sites["jax"] == sites["port"]
    html = sites["port"]["index.html"].decode()
    assert "Scaling efficiency" in html and "timestep" in html
    findings = json.loads(sites["port"]["findings.json"])
    at_c02 = [f for f in findings if f["kind"] == "regression" and f["commit"] == "c02"]
    assert at_c02, findings
    assert {"flop_scaling", "throughput_scaling"} & set(at_c02[0]["explanation"])
    assert any(n.startswith("badge_") for n in sites["port"])


def test_cli_ci_report_badge_validate_merge(tmp_path, capsys):
    make_history("jax", str(tmp_path / "talp"), runs=2)
    outs = {}
    for pkg, main in (("jax", main_j), ("port", main_t)):
        site = tmp_path / f"site_{pkg}"
        rcs = [main(["ci-report", "-i", str(tmp_path / "talp"), "-o", str(site),
                     "--regions", "timestep", "--print-tables"]),
               main(["badge", "-i", str(tmp_path / "talp"), "-o", str(site / "b.svg")]),
               main(["validate", "-i", str(tmp_path / "talp")])]
        make_history(pkg, str(tmp_path / f"new_{pkg}"), runs=1)
        rcs.append(main(["merge-history", "--history", str(tmp_path / "talp"),
                         "--current", str(tmp_path / f"new_{pkg}")]))
        assert rcs == [0, 0, 0, 0]
        outs[pkg] = (capsys.readouterr().out.replace(str(site), "<site>")
                     .replace(str(tmp_path / f"new_{pkg}"), "<new>"), tree_bytes(site))
        assert len(FDT.scan(str(tmp_path / f"new_{pkg}"))[0].runs) == 2
    assert outs["jax"] == outs["port"]
    assert "Global efficiency" in outs["port"][0]


def test_per_computation_breakdown_flows_to_report(tmp_path):
    """Operator and kernel counts of one counted step (the port's
    StepProfile.count) -> typed RegionRecord.computations -> drill-down."""
    a = torch.randn(32, 32)
    b = torch.randn(32, 32)
    _, prof = StepProfileT.count(lambda x, y: torch.tanh(x @ y).sum(), a, b)
    top = prof.top_computations(1)[0]
    assert top.hbm_bytes > 0 and "aten.mm" in prof.per_computation
    runs = {}
    for backend in ("monitor", "tracer"):
        ses = PerfSessionT(SessionConfigT(app_name="bd", backend=backend, sync_regions=False,
                                          respect_env=False, trace_dir=str(tmp_path / "tr")),
                           RCT(num_hosts=1, devices_per_host=1))
        with ses:
            ses.attach_static("train_step", prof)
            with ses.region("train_step"):
                ses.observe_step()
        runs[backend] = run = ses.finalize(git=False)
        reg = run.regions["train_step"]
        assert top.name in reg.computations and run.global_region.computations
        assert reg.computations[top.name].hbm_bytes <= reg.counters.hlo_bytes
        run.save(os.path.join(tmp_path, "talp", backend, "run_0.json"))
    assert (runs["monitor"].regions["train_step"].counters.to_json()
            == runs["tracer"].regions["train_step"].counters.to_json())
    exps = FDT.scan(str(tmp_path / "talp"))
    html = open(REPT.generate_report(exps, str(tmp_path / "site"))).read()
    assert "HLO computation breakdown" in html and "aten.mm" in html
    assert "comps_monitor" in html and "comps_tracer" in html


# ---------------------------------------------------------------------------
# the tracer on a real training loop (CPU, smoke config)
# ---------------------------------------------------------------------------


def test_tracer_on_a_smoke_train_loop_matches_the_monitor(tmp_path):
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.train import TrainConfig

    steps = 2
    cfg = smoke_config("tinyllama-1.1b")
    recs = {}
    for backend in ("monitor", "tracer"):
        data = SyntheticLM(DataConfig(global_batch=2, seq_len=32, vocab=512, pad_fraction=0.05))
        loop = TrainLoop(cfg, TrainConfig(total_steps=steps), data,
                         LoopConfig(steps=steps, lb_sample_every=1, monitor_backend=backend),
                         device="cpu")
        assert loop.session.backend == backend
        if backend == "tracer":
            loop.session.collector.trace_dir = str(tmp_path / "trace")
        loop.run()
        loop.finalize_run(str(tmp_path / "talp" / backend))
        (path,) = glob.glob(str(tmp_path / "talp" / backend / "talp_*.json"))
        recs[backend] = FDT.RunRecord.load(path)
    mon, tra = recs["monitor"], recs["tracer"]
    assert sorted(mon.regions) == sorted(tra.regions) == [GLOBAL_REGION, "initialize", "train_step"]
    assert tra.hardware == mon.hardware == "h100_sxm"
    for run in (mon, tra):
        assert all(FT.validate_pop(r.pop) == [] for r in run.regions.values())
    a, b = mon.regions["train_step"], tra.regions["train_step"]
    assert a.measurements.num_steps == b.measurements.num_steps == steps
    for k in ("useful_flops", "hlo_bytes", "model_flops"):
        va, vb = getattr(a.counters, k) / steps, getattr(b.counters, k) / steps
        assert va > 0 and va == pytest.approx(vb, rel=1e-12), k
    assert set(a.computations) == set(b.computations)
    np.testing.assert_allclose(a.measurements.data_lb, b.measurements.data_lb, rtol=1e-12)
    assert TRT.trace_storage_bytes(str(tmp_path / "trace")) > 0
