"""Where the benchmark's data lives, and how a cell, a configuration, a kind
of deployment and a metric are found by name.  Adding one is adding a file:

- ``configs/<config>.json``: a deployment's sizes, source and guarantees,
  and its ``kind``;
- ``kinds/<kind>.py``: a kind of deployment, with KIND (its file's stem),
  TINY (the CPU tests' configuration and cell sizes), ``pool`` and ``tail``
  (the draws from ``traffic.pool_rng(cell, seed)`` and
  ``traffic.rng_for(seed, TAIL)``) and ``System``:
  ``build``, ``open``, ``ingest_tail``, ``requests``, ``readings``,
  ``recorder``, ``work`` and ``judge``, with its plain reference under
  ``reference/``;
- ``workloads/<cell>.json``: a cell's traffic parameters (with
  ``pool_seed`` and ``"schedule": "epochs"`` where every seed should do the
  same work, ``gen/traffic.py``), its ``request``
  (any ``SearchRequest`` field by its name, ``harness/requests.py``), its
  check and its end-to-end metrics;
- ``metrics/<metric>.py``: one metric, with NAME, UNIT, BETTER, SOURCE,
  LAYER (per-layer metrics), MOVES and ``read(run)``.

A new kind's layers need no trace file: the port's own ``METRICS`` timers
are recorded as ``timer.<name>`` spans by ``harness/trace.py`` whatever
code observes them, and its counters reach a metric through
``RunRecord.delta``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
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


def load_kind(name: str):
    """The module of the deployment kind `name`, ``kinds/<name>.py``."""
    path = HERE / "kinds" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no deployment kind {name!r}: {path} does not "
                         f"exist")
    spec = importlib.util.spec_from_file_location(f"bench_port_kind_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    if getattr(mod, "KIND", None) != path.stem:
        raise SystemExit(f"{path} defines the kind "
                         f"{getattr(mod, 'KIND', None)!r}")
    return mod


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
