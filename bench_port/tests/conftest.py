"""Shared set-up of the benchmark's CPU tests: the harness's folders on the
path, the ``card`` marker, and cells cut to a size a CPU test can hold (each
kind's ``TINY``)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips inside the test "
        "where torch.cuda.is_available() is false)")


def tiny(name: str):
    """(cell, config) of a cell, cut to its kind's TINY sizes."""
    from harness import files

    cell = files.load_cell(name)
    config = files.load_config(cell["config"])
    c_over, cell_over = files.load_kind(config["kind"]).TINY
    config.update(c_over)
    cell.update(cell_over)
    cell["check"] = dict(cell["check"], sample=48)
    return cell, config


@pytest.fixture(scope="session")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_port_cache")
