# NOTE: deliberately no XLA_FLAGS here — smoke tests and benches run on the
# single real CPU device. Multi-device behaviour (sharding, elastic
# resharding, host load balance) is tested through subprocesses that set
# --xla_force_host_platform_device_count themselves (see test_elastic.py).
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# repo root, so tests can import shared fixtures from benchmarks/
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips when torch sees none"
    )
