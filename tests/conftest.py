"""Test configuration: force the CPU backend with 8 virtual devices.

Multi-device sharding is tested on a virtual CPU mesh
(xla_force_host_platform_device_count); the GPU path is exercised by
chip_smoke.py, which the ``gpu``-marked tests run in a child process on a
machine with a card. Must configure the platform before any JAX backend
initialization.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ngsamg.utils.jaxcfg import enable_persistent_cache, force_cpu

force_cpu(8)
enable_persistent_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where there is none"
    )
    config.addinivalue_line("markers", "slow: long-running test")
