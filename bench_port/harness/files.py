"""Where the benchmark's data lives, and how a cell, a configuration and a
metric are found by name.  Adding one is adding a file:

- ``configs/<config>.json``: a deployment's sizes, source and guarantees;
- ``workloads/<cell>.json``: a cell's traffic parameters, its check and its
  end-to-end metrics;
- ``metrics/<metric>.py``: one metric, with NAME, UNIT, BETTER, SOURCE,
  LAYER (per-layer metrics), MOVES and ``read(run)``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # bench_port/
ROOT = HERE.parent                                   # the checkout
CACHE = HERE / "cache"


def load_cell(name: str) -> dict:
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no cell {name!r}: {path} does not exist")
    cell = json.loads(path.read_text())
    if cell.get("name") != name:
        raise SystemExit(f"{path} names the cell {cell.get('name')!r}")
    return cell


def load_config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no configuration {name!r}: {path} does not exist")
    return json.loads(path.read_text())


def metric_modules() -> dict:
    """{metric name: module} for every file under metrics/."""
    out = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"bench_port_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if mod.NAME != path.stem:
            raise SystemExit(f"{path} defines the metric {mod.NAME!r}")
        out[mod.NAME] = mod
    return out


def per_layer_names(cell: str, benchmark: dict | None, modules: dict,
                    end_to_end: list[str]) -> list[str]:
    """The per-layer metrics a traced run of `cell` reports: those that
    BENCHMARK.json lists for it, by their ``workloads`` or, without one, by
    the end-to-end metric they move; every per-layer metric file where
    there is no BENCHMARK.json (its reader returns nothing where it has
    nothing to read)."""
    if benchmark is None:
        return [n for n, m in modules.items() if hasattr(m, "LAYER")]
    return [m["name"] for m in benchmark.get("per_layer", [])
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in end_to_end)]


def benchmark_json() -> dict | None:
    path = ROOT / "BENCHMARK.json"
    return json.loads(path.read_text()) if path.is_file() else None
