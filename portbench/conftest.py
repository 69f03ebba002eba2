"""pytest settings of the benchmark's own tests (portbench/tests): the card
marker. Whether a card is there is decided inside the `card` fixture, never
while a module is imported."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without CUDA)")
