"""repro_torch.core: TALP-Pages for PyTorch, the port of ``repro.core``.

Public API:
  MonitorConfig                 on-the-fly POP collection knobs (TALP)
  StepProfile                   counted per-step static counters (PAPI analogue)
  RunRecord / ResourceConfig    the JSON artifact schema (v3, shared)
  build_table / render_text     scaling-efficiency tables
  generate_report               static HTML report (TALP-Pages)
  scan / merge_history          CI folder handling
  post_process                  trace post-processing (Score-P/Extrae stand-in)

The collectors (``RegionMonitor``, ``EventTracer``) are constructed only
behind ``repro_torch.session.PerfSession``: select one with
``SessionConfig(backend="monitor"|"tracer")`` or ``TALP_ENABLE=1
TALP_BACKEND=...``. The report side renders the records of both packages;
``python -m repro_torch.core.pages`` is its ``talp`` CLI.
"""

from repro_torch.core.factors import compute_pop, validate_pop
from repro_torch.core.folder import Experiment, git_metadata, merge_history, scan
from repro_torch.core.hardware import (
    DEFAULT_TARGET,
    H100_SXM,
    TPU_V5E,
    TPU_V5P,
    ChipSpec,
    get_target,
)
from repro_torch.core.monitor import MonitorConfig
from repro_torch.core.profile import StepProfile
from repro_torch.core.records import (
    GLOBAL_REGION,
    SCHEMA_VERSION,
    ComputationCounters,
    RegionCounters,
    RegionMeasurements,
    RegionRecord,
    ResourceConfig,
    RunRecord,
)
from repro_torch.core.regression import ComputationShift, Finding, detect, explain_computations
from repro_torch.core.report import badge_svg, generate_report
from repro_torch.core.scaling import ScalingTable, build_table, latest_per_config, render_text
from repro_torch.core.timeseries import build_series
from repro_torch.core.tracer import post_process, trace_storage_bytes

__all__ = [
    "MonitorConfig", "StepProfile", "RunRecord", "RegionRecord",
    "RegionCounters", "RegionMeasurements", "ComputationCounters",
    "ResourceConfig", "GLOBAL_REGION", "SCHEMA_VERSION",
    "ComputationShift", "Finding", "detect", "explain_computations",
    "ChipSpec", "H100_SXM", "TPU_V5E", "TPU_V5P", "DEFAULT_TARGET", "get_target",
    "compute_pop", "validate_pop", "build_table", "render_text", "ScalingTable",
    "latest_per_config", "build_series", "generate_report", "badge_svg",
    "scan", "merge_history", "git_metadata", "Experiment",
    "post_process", "trace_storage_bytes",
]
