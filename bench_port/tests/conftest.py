"""Shared set-up of the benchmark's CPU tests: the harness's folders on the
path, the ``card`` marker, and cells cut to a size a CPU test can hold."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

# name -> (config sizes, cell sizes) for the CPU
TINY = {
    "text": ({"n_docs": 20_000}, {"pool": 192, "batch": 64, "tail": 200}),
    "vector": ({"n_vectors": 12_000}, {"pool": 96, "batch": 32,
                                       "tail": 200}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips inside the test "
        "where torch.cuda.is_available() is false)")


def tiny(name: str):
    """(cell, config) of a cell, cut to TINY's sizes."""
    from harness import files

    cell = files.load_cell(name)
    config = files.load_config(cell["config"])
    c_over, cell_over = TINY[config["kind"]]
    config.update(c_over)
    cell.update(cell_over)
    cell["check"] = dict(cell["check"], sample=48)
    return cell, config


@pytest.fixture(scope="session")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_port_cache")
