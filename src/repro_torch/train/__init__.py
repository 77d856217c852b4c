"""Training (``repro.train``): the train step and the monitored loop."""
