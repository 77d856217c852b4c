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

The names below resolve lazily, so that the report side (the ``talp``
CLI) imports no torch: only the collectors and the step profile need it.
"""

import importlib

_EXPORTS = {
    "factors": ("compute_pop", "validate_pop"),
    "folder": ("Experiment", "git_metadata", "merge_history", "scan"),
    "hardware": ("DEFAULT_TARGET", "H100_SXM", "TPU_V5E", "TPU_V5P", "ChipSpec", "get_target"),
    "monitor": ("MonitorConfig",),
    "profile": ("StepProfile",),
    "records": ("GLOBAL_REGION", "SCHEMA_VERSION", "ComputationCounters", "RegionCounters",
                "RegionMeasurements", "RegionRecord", "ResourceConfig", "RunRecord"),
    "regression": ("ComputationShift", "Finding", "detect", "explain_computations"),
    "report": ("badge_svg", "generate_report"),
    "scaling": ("ScalingTable", "build_table", "latest_per_config", "render_text"),
    "timeseries": ("build_series",),
    "tracer": ("post_process", "trace_storage_bytes"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

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


def __getattr__(name: str):
    if name in _MODULE_OF:
        return getattr(importlib.import_module(f"repro_torch.core.{_MODULE_OF[name]}"), name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
