"""Helpers of the benchmark's tests: the test-size configurations and mix
under portbench/tests/data, and a CPU run of a cell built from them."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(ROOT, "portbench", "tests", "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def make_cell(config: str, traffic: str = "tiny"):
    """A spec.Cell of a test configuration and mix, with BENCHMARK.json's
    metrics."""
    from portbench.spec import Cell, load_json

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    return Cell(f"test.{config}", 1, load_json(os.path.join(DATA, f"{config}.json")),
                load_json(os.path.join(DATA, f"{traffic}.json")),
                bench["end_to_end"], bench["per_layer"])


@pytest.fixture
def cuda_card():
    """Skips a test that needs an NVIDIA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")
