"""Regression detection + explanation (paper §Reports / Figure 7).

The paper's value proposition over wall-clock-only CI monitors: when
elapsed time changes, the POP factor hierarchy *explains* it. Given the
time series of one (region, resource configuration), we compare each run
to the previous one; if elapsed time moved more than ``threshold``, we walk
the factor tree to the deepest factor whose change is sufficient to explain
the move ("OpenMP serialization efficiency is responsible for the parallel
efficiency increase" in the paper's GENE-X study becomes e.g. "dispatch
efficiency is responsible for the parallel-efficiency drop" here).

Schema v3 records carry a typed per-computation counter breakdown
(``RegionRecord.computations``: HLO computations in the JAX package's
records, operators and kernels in the port's), so the walk no longer stops
at the factor leaf: ``detect``/``explain_computations`` descend one more
level and the ``Finding`` names the computation(s) whose counter share
shifted most — e.g. "explained by Dispatch efficiency -> `aten.mm`
(+41% hbm bytes)". The port's copy of ``repro.core.regression``.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import factors as F
from repro_torch.core.records import RANK_METRIC
from repro_torch.core.timeseries import RegionSeries

# Which counter metric a leaf factor implicates. Communication factors move
# with collective traffic; FLOP scaling with executed FLOPs; throughput /
# dispatch with kernel cost, which device-memory traffic usually drives.
# Factors without an entry (load balances) are measured, not counter-derived,
# so attribution falls back to the largest shift across all metrics.
_LEAF_METRIC: dict[str, str] = {
    F.COMM_EFF: "collective_operand_bytes",
    F.ICI_COMM_EFF: "collective_operand_bytes",
    F.DCN_COMM_EFF: "collective_operand_bytes",
    F.COMP_SCALABILITY: "flops",
    F.FLOP_SCALING: "flops",
    F.THROUGHPUT_SCALING: "hbm_bytes",
    F.DISPATCH_EFF: "hbm_bytes",
}

_METRIC_LABELS = {
    "flops": "flops",
    "hbm_bytes": "hbm bytes",
    "collective_operand_bytes": "collective bytes",
}


@dataclasses.dataclass
class ComputationShift:
    """One computation whose counter moved between two runs."""

    name: str
    metric: str          # which ComputationCounters metric shifted
    before: float
    after: float
    share_shift: float   # |after-before| / max(metric totals of both runs)

    @property
    def rel_change(self) -> float:
        if self.before > 0:
            return (self.after - self.before) / self.before
        return float("inf") if self.after > 0 else 0.0

    def describe(self) -> str:
        label = _METRIC_LABELS.get(self.metric, self.metric)
        if self.before > 0 and self.after > 0:
            return f"`{self.name}` ({self.rel_change * 100.0:+.0f}% {label})"
        if self.before == 0:
            return f"`{self.name}` (new, {label})"
        return f"`{self.name}` (gone, {label})"

    def to_json(self) -> dict:
        rel = self.rel_change
        return {
            "name": self.name, "metric": self.metric,
            "before": self.before, "after": self.after,
            # inf (computation appeared) is not valid JSON; null means "new"
            "rel_change": rel if math.isfinite(rel) else None,
            "share_shift": self.share_shift,
        }


@dataclasses.dataclass
class Finding:
    kind: str            # "regression" | "improvement"
    region: str
    config_label: str
    timestamp: str
    commit: str | None
    elapsed_before: float
    elapsed_after: float
    rel_change: float    # (after-before)/before; negative = faster
    explanation: list[str]   # factor path, outermost -> deepest
    factor_changes: dict[str, tuple[float, float]]
    # one level deeper than the factor leaf: the computations whose counter
    # share shifted most (empty when the records carry no breakdown)
    computations: list[ComputationShift] = dataclasses.field(default_factory=list)

    def describe(self) -> str:
        direction = "improvement" if self.rel_change < 0 else "regression"
        pct = abs(self.rel_change) * 100.0
        where = f"{self.region} @ {self.config_label}"
        head = f"{direction} of {pct:.1f}% in elapsed time ({where})"
        if self.commit:
            head += f" at commit {self.commit}"
        if not self.explanation:
            tail = " — no factor change explains it (likely machine noise or external change)"
            if self.computations:
                tail = " — no factor change explains it; counter shift in " + ", ".join(
                    c.describe() for c in self.computations
                )
            return head + tail
        path = " -> ".join(F.DISPLAY_NAMES.get(k, k) for k in self.explanation)
        leaf = self.explanation[-1]
        b, a = self.factor_changes[leaf]
        out = f"{head} — explained by {path} ({b:.3f} -> {a:.3f})"
        if self.computations:
            out += " -> " + ", ".join(c.describe() for c in self.computations)
        return out


def _tree_children(key: str, node=F.FACTOR_TREE):
    name, children = node
    if name == key:
        return children
    for ch in children:
        found = _tree_children(key, ch)
        if found is not None:
            return found
    return None


def explain(
    before: dict[str, float],
    after: dict[str, float],
    factor_threshold: float = 0.02,
) -> tuple[list[str], dict[str, tuple[float, float]]]:
    """Walk the factor tree from the root; at each level descend into the
    child with the largest relative change (if above threshold). Returns the
    path and the (before, after) values of every factor on it."""
    path: list[str] = []
    changes: dict[str, tuple[float, float]] = {}
    key = F.GLOBAL_EFF
    while True:
        b, a = before.get(key), after.get(key)
        if b is None or a is None or b <= 0:
            break
        rel = abs(a - b) / b
        if rel < factor_threshold:
            break
        path.append(key)
        changes[key] = (b, a)
        children = _tree_children(key) or []
        best, best_rel = None, factor_threshold
        for child_node in children:
            ck = child_node[0]
            cb, ca = before.get(ck), after.get(ck)
            if cb is None or ca is None or cb <= 0:
                continue
            crel = abs(ca - cb) / cb
            if crel > best_rel:
                best, best_rel = ck, crel
        if best is None:
            break
        key = best
    return path, changes


def explain_computations(
    before: dict[str, dict[str, float]],
    after: dict[str, dict[str, float]],
    metric: str | None = None,
    top_n: int = 3,
    min_share_shift: float = 0.02,
) -> list[ComputationShift]:
    """Descend below the factor leaf: rank computations by how much of
    the region's counter total their change accounts for.

    ``before``/``after`` map computation name -> {metric -> value} (the
    ``SeriesPoint.computations`` shape). With ``metric`` given (from the
    factor leaf via ``_LEAF_METRIC``) only that counter is ranked; otherwise
    each computation is scored on its most-shifted metric. Share-of-total
    ranking (|delta| / max(total_before, total_after)) keeps tiny-but-noisy
    computations out even when their relative change is huge.

    The persisted breakdowns are top-N truncated (MonitorConfig
    .top_computations, ranked by ``records.RANK_METRIC``), so a computation
    missing from one side may merely have fallen below that side's cut, not
    appeared/vanished. A one-sided computation is attributed only when its
    RANK_METRIC value exceeds the absent side's cut (the smallest retained
    value) — it could not have been truncated away — and is then genuinely
    "new"/"gone" (missing values are 0).
    """
    if not before or not after:
        # one side carries no breakdown at all (pre-v3 record): any
        # attribution would mark every computation new/gone — say nothing
        return []
    metrics = [metric] if metric else list(_METRIC_LABELS)
    totals = {
        m: max(
            sum(c.get(m, 0.0) for c in before.values()),
            sum(c.get(m, 0.0) for c in after.values()),
            1e-30,
        )
        for m in metrics
    }
    cut_b = min((c.get(RANK_METRIC, 0.0) for c in before.values()), default=0.0)
    cut_a = min((c.get(RANK_METRIC, 0.0) for c in after.values()), default=0.0)
    shifts: list[ComputationShift] = []
    for name in {*before, *after}:
        b_c, a_c = before.get(name), after.get(name)
        if b_c is None and a_c.get(RANK_METRIC, 0.0) <= cut_b:
            continue  # may just sit below before's truncation cut
        if a_c is None and b_c.get(RANK_METRIC, 0.0) <= cut_a:
            continue  # may just sit below after's truncation cut
        best: ComputationShift | None = None
        for m in metrics:
            b = b_c.get(m, 0.0) if b_c is not None else 0.0
            a = a_c.get(m, 0.0) if a_c is not None else 0.0
            share = abs(a - b) / totals[m]
            if best is None or share > best.share_shift:
                best = ComputationShift(
                    name=name, metric=m, before=b, after=a, share_shift=share
                )
        if best is not None and best.share_shift >= min_share_shift:
            shifts.append(best)
    shifts.sort(key=lambda s: s.share_shift, reverse=True)
    return shifts[:top_n]


def _with_cross_run_scalability(
    before: dict[str, float], after: dict[str, float]
) -> dict[str, float]:
    """Recompute ``after``'s computation-scalability branch relative to
    ``before`` (same input, same resources => strong-scaling assumption:
    total executed FLOPs should be constant; a remat/recompute bug shows up
    as flop_scaling < 1, a slower-kernel bug as throughput_scaling < 1)."""
    out = dict(after)
    bf, af = before.get("_useful_flops", 0.0), after.get("_useful_flops", 0.0)
    flop = bf / af if bf > 0 and af > 0 else 1.0
    bt, at_ = before.get("_device_time_s", 0.0), after.get("_device_time_s", 0.0)
    if bf > 0 and af > 0 and bt > 0 and at_ > 0:
        thr = (af / at_) / (bf / bt)
    else:
        thr = 1.0
    out[F.FLOP_SCALING] = flop
    out[F.THROUGHPUT_SCALING] = thr
    out[F.FREQUENCY_SCALING] = 1.0
    out[F.COMP_SCALABILITY] = flop * thr
    if F.PARALLEL_EFF in out:
        out[F.GLOBAL_EFF] = out[F.PARALLEL_EFF] * out[F.COMP_SCALABILITY]
    return out


def detect(
    series: RegionSeries,
    config_label: str,
    threshold: float = 0.05,
    factor_threshold: float = 0.02,
) -> list[Finding]:
    """Scan consecutive runs of one region/configuration for elapsed-time
    changes beyond ``threshold`` and explain each via the factor tree."""
    findings: list[Finding] = []
    pts = series.points
    for prev, cur in zip(pts, pts[1:]):
        eb = prev.values.get(F.ELAPSED_S)
        ea = cur.values.get(F.ELAPSED_S)
        if not eb or ea is None or eb <= 0:
            continue
        rel = (ea - eb) / eb
        if abs(rel) < threshold:
            continue
        after = _with_cross_run_scalability(prev.values, cur.values)
        path, changes = explain(prev.values, after, factor_threshold)
        leaf_metric = _LEAF_METRIC.get(path[-1]) if path else None
        comps = explain_computations(
            prev.computations, cur.computations, metric=leaf_metric
        )
        findings.append(
            Finding(
                kind="improvement" if rel < 0 else "regression",
                region=series.region,
                config_label=config_label,
                timestamp=cur.timestamp,
                commit=cur.commit,
                elapsed_before=eb,
                elapsed_after=ea,
                rel_change=rel,
                explanation=path,
                factor_changes=changes,
                computations=comps,
            )
        )
    return findings
