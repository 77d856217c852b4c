"""Static HTML report + SVG badges (paper §TALP-Pages, §Reports).

Produces a fully self-contained static site (inline CSS/JS/SVG, zero
external assets — it must render from GitLab/GitHub Pages artifact hosting
with no server): per-experiment scaling-efficiency tables, time-evolution
plots with client-side region toggling, regression findings, and SVG
parallel-efficiency badges per resource configuration.

The port's copy of ``repro.core.report``. The page embeds no timestamp, and
its words are the JAX package's (the "MXU utilization" row, the "HLO
computation breakdown" drill-down, which for the port's records lists
operators and kernels): on one folder of records both packages write the
same bytes.
"""

from __future__ import annotations

import html
import json
import os
import re
from typing import Sequence

from repro_torch.core import factors as F
from repro_torch.core import regression as _regression
from repro_torch.core import scaling as _scaling
from repro_torch.core import timeseries as _timeseries
from repro_torch.core.folder import Experiment
from repro_torch.core.records import GLOBAL_REGION

_CSS = """
body{font-family:-apple-system,Segoe UI,Helvetica,Arial,sans-serif;margin:2rem;
     color:#1a1a1a;max-width:1200px}
h1{border-bottom:2px solid #444}
h2{margin-top:2.2rem;border-bottom:1px solid #bbb}
table.pop{border-collapse:collapse;margin:0.8rem 0;font-size:0.92rem}
table.pop th,table.pop td{border:1px solid #999;padding:3px 10px;text-align:right}
table.pop td.name{text-align:left;font-family:ui-monospace,monospace;white-space:pre}
td.good{background:#bfe3bf}td.ok{background:#f5e6a8}td.bad{background:#f3b8b8}
td.na{color:#999}
.badge{margin-right:0.6rem}
.plot{margin:0.5rem 1rem 1rem 0;display:inline-block;vertical-align:top}
.plot svg{background:#fcfcfc;border:1px solid #ddd}
.legend{font-size:0.8rem}
.finding-regression{color:#a00;font-weight:600}
.finding-improvement{color:#060;font-weight:600}
.meta{color:#666;font-size:0.85rem}
details{margin:0.4rem 0}
"""

_JS = """
function toggleRegion(exp, region, on) {
  document.querySelectorAll('[data-exp="'+exp+'"][data-region="'+region+'"]')
    .forEach(el => { el.style.display = on ? '' : 'none'; });
}
function toggleCompMetric(exp, metric) {
  document.querySelectorAll('[data-exp="'+exp+'"][data-cmetric]')
    .forEach(el => {
      el.style.display = (el.getAttribute('data-cmetric') === metric)
        ? '' : 'none';
    });
}
"""

# the per-computation counter metrics the client-side toggle switches
# between (keys of records.ComputationCounters.METRICS)
COMP_METRICS = (
    ("hbm_bytes", "HBM bytes"),
    ("flops", "FLOPs"),
    ("collective_operand_bytes", "collective bytes"),
)
DEFAULT_COMP_METRIC = "hbm_bytes"

_PALETTE = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e",
            "#8c564b", "#e377c2", "#17becf", "#7f7f7f", "#bcbd22"]


def _cell_class(key: str, v: float | None) -> str:
    if v is None:
        return "na"
    if key in (F.ELAPSED_S, F.ACHIEVED_TFLOPS, F.MXU_UTIL):
        return ""
    if v >= 0.8:
        return "good"
    if v >= 0.6:
        return "ok"
    return "bad"


# ---------------------------------------------------------------------------
# badges
# ---------------------------------------------------------------------------


def badge_svg(label: str, value: float | None) -> str:
    txt = "n/a" if value is None else f"{value:.2f}"
    color = "#9f9f9f"
    if value is not None:
        color = "#4c1" if value >= 0.8 else ("#dfb317" if value >= 0.6 else "#e05d44")
    lw = 7 * len(label) + 10
    vw = 7 * len(txt) + 10
    return f"""<svg xmlns="http://www.w3.org/2000/svg" width="{lw+vw}" height="20" role="img">
<rect width="{lw}" height="20" fill="#555"/>
<rect x="{lw}" width="{vw}" height="20" fill="{color}"/>
<g fill="#fff" text-anchor="middle" font-family="Verdana,sans-serif" font-size="11">
<text x="{lw/2}" y="14">{html.escape(label)}</text>
<text x="{lw + vw/2}" y="14">{txt}</text></g></svg>"""


# ---------------------------------------------------------------------------
# SVG line plots
# ---------------------------------------------------------------------------


def _svg_plot(
    title: str,
    series: list[tuple[str, list[float]]],
    xlabels: list[str],
    width: int = 420,
    height: int = 190,
    y01: bool = False,
) -> str:
    """Tiny dependency-free polyline chart."""
    ml, mr, mt, mb = 46, 8, 22, 34
    pw, ph = width - ml - mr, height - mt - mb
    ys = [v for _, vals in series for v in vals if v == v]
    if not ys:
        return ""
    ymin, ymax = (0.0, 1.05) if y01 else (min(ys), max(ys))
    if ymax <= ymin:
        ymax = ymin + (abs(ymin) if ymin else 1.0) * 0.1 + 1e-12
    pad = 0.06 * (ymax - ymin)
    if not y01:
        ymin, ymax = ymin - pad, ymax + pad
    n = max(len(xlabels), 2)

    def X(i: int) -> float:
        return ml + pw * (i / (n - 1))

    def Y(v: float) -> float:
        return mt + ph * (1 - (v - ymin) / (ymax - ymin))

    parts = [
        f'<svg width="{width}" height="{height}" xmlns="http://www.w3.org/2000/svg">',
        f'<text x="{ml}" y="14" font-size="12" font-weight="600">{html.escape(title)}</text>',
    ]
    for frac in (0.0, 0.5, 1.0):
        yv = ymin + frac * (ymax - ymin)
        yy = Y(yv)
        parts.append(
            f'<line x1="{ml}" y1="{yy:.1f}" x2="{width-mr}" y2="{yy:.1f}" stroke="#e0e0e0"/>'
            f'<text x="{ml-4}" y="{yy+4:.1f}" font-size="9" text-anchor="end">{yv:.3g}</text>'
        )
    for i, lab in enumerate(xlabels):
        parts.append(
            f'<text x="{X(i):.1f}" y="{height-4}" font-size="8" text-anchor="middle">'
            f"{html.escape(lab[:12])}</text>"
        )
    legend_y = mt
    for si, (name, vals) in enumerate(series):
        color = _PALETTE[si % len(_PALETTE)]
        pts = " ".join(
            f"{X(i):.1f},{Y(v):.1f}" for i, v in enumerate(vals) if v == v
        )
        if pts:
            parts.append(
                f'<polyline points="{pts}" fill="none" stroke="{color}" stroke-width="1.6"/>'
            )
            for i, v in enumerate(vals):
                if v == v:
                    parts.append(
                        f'<circle cx="{X(i):.1f}" cy="{Y(v):.1f}" r="2.3" fill="{color}"/>'
                    )
        parts.append(
            f'<text x="{width-mr}" y="{legend_y}" font-size="9" text-anchor="end" '
            f'fill="{color}">{html.escape(name)}</text>'
        )
        legend_y += 11
    parts.append("</svg>")
    return "".join(parts)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def table_html(table: _scaling.ScalingTable) -> str:
    rows = [
        "<table class='pop'><tr><th>Metrics</th>"
        + "".join(
            f"<th>{html.escape(c.label)}{' (ref)' if c.is_reference else ''}</th>"
            for c in table.columns
        )
        + "</tr>"
    ]
    for key, depth in F.iter_tree():
        vals = table.row(key)
        if all(v is None for v in vals):
            continue
        name = "&nbsp;" * (2 * depth) + html.escape(
            ("- " if depth else "") + F.DISPLAY_NAMES.get(key, key)
        )
        cells = "".join(
            f"<td class='{_cell_class(key, v)}'>{'-' if v is None else f'{v:.2f}'}</td>"
            for v in vals
        )
        rows.append(f"<tr><td class='name'>{name}</td>{cells}</tr>")
    for key in F.INFO_ROWS:
        vals = table.row(key)
        if all(v is None for v in vals):
            continue
        cells = "".join(
            f"<td>{'-' if v is None else f'{v:.4g}'}</td>" for v in vals
        )
        rows.append(
            f"<tr><td class='name'>{html.escape(F.DISPLAY_NAMES.get(key, key))}</td>{cells}</tr>"
        )
    rows.append("</table>")
    rows.append(
        f"<p class='meta'>scaling mode: <b>{table.mode}</b>, region: "
        f"<b>{html.escape(table.region)}</b>, reference: least resources, "
        f"latest run per configuration</p>"
    )
    return "".join(rows)


def _sparkline(
    vals: list[float], width: int = 96, height: int = 18,
    color: str = "#1f77b4",
) -> str:
    """Inline mini-trend of one computation metric over the run history."""
    finite = [(i, v) for i, v in enumerate(vals) if v == v]
    if len(finite) < 2:
        return ""
    ys = [v for _, v in finite]
    ymin, ymax = min(ys), max(ys)
    if ymax <= ymin:
        ymax = ymin + (abs(ymin) if ymin else 1.0) * 0.1 + 1e-12
    n = max(len(vals), 2)
    pts = " ".join(
        f"{1 + (width - 2) * i / (n - 1):.1f},"
        f"{1 + (height - 2) * (1 - (v - ymin) / (ymax - ymin)):.1f}"
        for i, v in finite
    )
    lx, ly = (
        1 + (width - 2) * finite[-1][0] / (n - 1),
        1 + (height - 2) * (1 - (finite[-1][1] - ymin) / (ymax - ymin)),
    )
    return (
        f'<svg width="{width}" height="{height}" '
        'xmlns="http://www.w3.org/2000/svg" style="vertical-align:middle">'
        f'<polyline points="{pts}" fill="none" stroke="{color}" '
        'stroke-width="1.2"/>'
        f'<circle cx="{lx:.1f}" cy="{ly:.1f}" r="1.8" fill="{color}"/></svg>'
    )


def comp_metric_toggle_html(eid: str) -> str:
    """Radio group driving every ``data-cmetric`` element of an experiment
    (drill-down sparklines + per-computation time-evolution plots)."""
    labels = []
    for key, label in COMP_METRICS:
        checked = " checked" if key == DEFAULT_COMP_METRIC else ""
        labels.append(
            f"<label><input type='radio' name='cmetric_{eid}'{checked} "
            f"onchange=\"toggleCompMetric('{eid}','{key}')\"/>"
            f"{html.escape(label)}</label> "
        )
    return (
        "<div class='legend'>per-computation metric: "
        + "".join(labels)
        + "</div>"
    )


def computation_breakdown_html(
    run, eid: str, top_n: int = 8, open_details: bool = False,
    series_by_region: dict | None = None,
) -> str:
    """Per-experiment drill-down: collapsible per-region tables of the
    heaviest computations (typed ``RegionRecord.computations``, schema
    v3). Anchored at ``comps_{eid}`` so regression findings and the
    time-evolution plots can deep-link into it. ``series_by_region``
    (region -> metric -> computation -> values over the run history) adds a
    trend sparkline per row, switched by the experiment's metric toggle."""
    parts: list[str] = []
    series_by_region = series_by_region or {}
    for region, reg in run.regions.items():
        comps = reg.top_computations(top_n)
        if not comps:
            continue
        metric_series = series_by_region.get(region, {})
        has_spark = any(metric_series.get(m) for m, _ in COMP_METRICS)
        rows = [
            "<table class='pop'><tr><th>computation</th><th>kind</th>"
            "<th>mult</th><th>GFLOP</th><th>HBM GiB</th><th>coll GiB</th>"
            + ("<th>trend</th>" if has_spark else "")
            + "</tr>"
        ]
        for c in comps:
            spark_cells = ""
            if has_spark:
                spans = []
                for m, _label in COMP_METRICS:
                    vals = metric_series.get(m, {}).get(c.name)
                    svg = _sparkline(vals) if vals else ""
                    hide = " style='display:none'" if m != DEFAULT_COMP_METRIC else ""
                    spans.append(
                        f"<span data-exp='{eid}' data-cmetric='{m}'{hide}>"
                        f"{svg}</span>"
                    )
                spark_cells = f"<td>{''.join(spans)}</td>"
            rows.append(
                f"<tr><td class='name'>{html.escape(c.name[:48])}</td>"
                f"<td>{html.escape(c.kind)}</td>"
                f"<td>{c.multiplicity:.0f}</td>"
                f"<td>{c.flops / 1e9:.2f}</td>"
                f"<td>{c.hbm_bytes / 2**30:.3f}</td>"
                f"<td>{c.collective_operand_bytes / 2**30:.3f}</td>"
                f"{spark_cells}</tr>"
            )
        rows.append("</table>")
        parts.append(
            f"<details{' open' if open_details else ''}>"
            f"<summary>HLO computation breakdown — region "
            f"<code>{html.escape(region)}</code> (top {len(comps)}, latest run)"
            f"</summary>{''.join(rows)}</details>"
        )
    if not parts:
        return ""
    # eid is sanitized to [A-Za-z0-9_-] by the caller, so id == href target
    return f"<div id='comps_{eid}'>{''.join(parts)}</div>"


# ---------------------------------------------------------------------------
# full report
# ---------------------------------------------------------------------------


def generate_report(
    experiments: Sequence[Experiment],
    out_dir: str,
    regions: Sequence[str] = (),
    region_for_badge: str | None = None,
    overlap_fraction: float = 0.0,
    title: str = "TALP-Pages performance report",
    top_computations: int = 8,
) -> str:
    """Write the report site under ``out_dir``; returns index.html path."""
    os.makedirs(out_dir, exist_ok=True)
    badge_region = region_for_badge or GLOBAL_REGION
    all_regions = [GLOBAL_REGION, *[r for r in regions if r != GLOBAL_REGION]]

    body: list[str] = [f"<h1>{html.escape(title)}</h1>"]
    summary_findings: list[_regression.Finding] = []

    for exp in experiments:
        # id-safe: eid feeds element ids, #fragment hrefs and JS strings
        eid = re.sub(r"[^A-Za-z0-9_-]", "_", exp.rel_path.replace(os.sep, "__"))
        body.append(f"<h2>Experiment: {html.escape(exp.name)}</h2>")
        body.append(
            f"<p class='meta'>{len(exp.runs)} runs, "
            f"{len({r.resources.label for r in exp.runs})} resource configurations</p>"
        )

        # --- badges (one per resource configuration) ---
        latest = _scaling.latest_per_config(exp.runs)
        for run in latest:
            reg = run.regions.get(badge_region)
            value = reg.pop.get(F.PARALLEL_EFF) if reg else None
            name = f"badge_{eid}_{run.resources.label}.svg"
            with open(os.path.join(out_dir, name), "w") as f:
                f.write(badge_svg(f"parallel eff {run.resources.label}", value))
            body.append(f"<span class='badge'><img src='{name}' alt='badge'/></span>")

        # --- scaling-efficiency tables (per requested region) ---
        for region in all_regions:
            table = _scaling.build_table(
                exp.runs, region=region, overlap_fraction=overlap_fraction
            )
            if table is None or not table.columns:
                continue
            body.append(f"<h3>Scaling efficiency — region <code>{html.escape(region)}</code></h3>")
            body.append(table_html(table))

        # --- time-evolution series (also feeds the drill-down sparklines) ---
        cfg_series = _timeseries.build_series(exp.runs)
        series_by_label = {cs.label: cs for cs in cfg_series}

        # --- per-computation drill-down (latest run that recorded one) ---
        has_breakdown = False
        if top_computations > 0:
            for run in reversed(latest):
                cs = series_by_label.get(run.resources.label)
                series_by_region = {
                    rn: {
                        m: rs.computation_series(m) for m, _ in COMP_METRICS
                    }
                    for rn, rs in (cs.regions if cs else {}).items()
                    if len(rs.points) >= 2
                }
                bd = computation_breakdown_html(
                    run, eid, top_computations,
                    series_by_region=series_by_region,
                )
                if bd:
                    body.append(comp_metric_toggle_html(eid))
                    body.append(bd)
                    has_breakdown = True
                    break
        for cs in cfg_series:
            if all(len(rs.points) < 2 for rs in cs.regions.values()):
                continue
            body.append(f"<h3>Time evolution — {html.escape(cs.label)}</h3>")
            shown_regions = [r for r in cs.regions if r in all_regions] or list(cs.regions)
            body.append("<div class='legend'>regions: ")
            for rn in shown_regions:
                body.append(
                    f"<label><input type='checkbox' checked "
                    f"onchange=\"toggleRegion('{eid}','{html.escape(rn)}',this.checked)\"/>"
                    f"{html.escape(rn)}</label> "
                )
            body.append("</div>")
            for rn in shown_regions:
                rs = cs.regions[rn]
                xlabels = [
                    (p.commit or p.timestamp.replace("T", " ")[:16]) for p in rs.points
                ]
                body.append(
                    f"<div data-exp='{eid}' data-region='{html.escape(rn)}'>"
                    f"<b>{html.escape(rn)}</b><br/>"
                )
                for gtitle, keys in _timeseries.SERIES_GROUPS:
                    series = []
                    for k in keys:
                        vals = [p.values.get(k, float("nan")) for p in rs.points]
                        if any(v == v for v in vals):
                            series.append((F.DISPLAY_NAMES.get(k, k), vals))
                    if not series:
                        continue
                    y01 = gtitle not in ("Elapsed time [s]", "Computation")
                    svg = _svg_plot(f"{gtitle} ({cs.label})", series, xlabels, y01=y01)
                    if svg:
                        body.append(f"<span class='plot'>{svg}</span>")
                # per-computation time evolution (heaviest computations;
                # one plot per counter metric, switched client-side by the
                # experiment's metric toggle)
                if top_computations > 0:
                    any_comp_plot = False
                    for metric, mlabel in COMP_METRICS:
                        comp_names = rs.top_computation_names(
                            min(5, top_computations), metric=metric
                        )
                        if not comp_names:
                            continue
                        cseries = rs.computation_series(metric)
                        svg = _svg_plot(
                            f"Top computations, {mlabel} ({cs.label})",
                            [(name[-28:], cseries[name]) for name in comp_names],
                            xlabels,
                        )
                        if not svg:
                            continue
                        hide = (
                            " style='display:none'"
                            if metric != DEFAULT_COMP_METRIC
                            else ""
                        )
                        body.append(
                            f"<span class='plot' data-exp='{eid}' "
                            f"data-cmetric='{metric}'{hide}>{svg}</span>"
                        )
                        any_comp_plot = True
                    if any_comp_plot and has_breakdown:
                        body.append(
                            f"<p class='meta'><a href='#comps_{eid}'>"
                            "per-computation drill-down</a></p>"
                        )
                body.append("</div>")

            # --- findings (regressions / improvements) ---
            for rn in shown_regions:
                findings = _regression.detect(cs.regions[rn], cs.label)
                summary_findings.extend(findings)
                for fd in findings:
                    link = (
                        f" <a href='#comps_{eid}'>[computation breakdown]</a>"
                        if has_breakdown and fd.computations
                        else ""
                    )
                    body.append(
                        f"<p class='finding-{fd.kind}'>&#9888; "
                        f"{html.escape(fd.describe())}{link}</p>"
                    )

    page = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>{_CSS}</style>"
        f"<script>{_JS}</script></head><body>"
        + "".join(body)
        + "</body></html>"
    )
    index = os.path.join(out_dir, "index.html")
    with open(index, "w") as f:
        f.write(page)
    with open(os.path.join(out_dir, "findings.json"), "w") as f:
        json.dump(
            [
                {
                    "kind": fd.kind, "region": fd.region, "config": fd.config_label,
                    "timestamp": fd.timestamp, "commit": fd.commit,
                    "rel_change": fd.rel_change,
                    "explanation": fd.explanation,
                    "computations": [c.to_json() for c in fd.computations],
                    "description": fd.describe(),
                }
                for fd in summary_findings
            ],
            f,
            indent=1,
        )
    return index
