"""The port's TALP collection side (``repro.core``): run records (schema
v3), POP factors, the H100 ``ChipSpec``, the counted ``StepProfile`` and
the on-the-fly ``RegionMonitor``, which code reaches through
``repro_torch.session.PerfSession``. The report side (scaling tables,
regression, pages) is not ported yet (ROADMAP.md Queue 1, item 7)."""
