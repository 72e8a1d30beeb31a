"""Kinds of deployment as files: ``files.load_kind`` finds one by name, a
kind dropped into a copy of the benchmark runs with no other file edited,
and the two kinds give, on one seed at the CPU's sizes, the draws, the
requests, the served work and the check's numbers that the harness gave
before kinds were files (``golden_parent.json``, recorded from commit
e80ffce's harness by the same fixed batches), on the traffic parameters the
cells had there (``PARENT_LESS``: the keys added since, which fix the pool
and the schedule, taken out)."""

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import run
import seekstorm_tpu_torch as st
from conftest import tiny
from gen import traffic
from harness import files

SEED = 2**31 + 77
BATCHES = 3
GOLDEN = json.loads((Path(__file__).parent / "golden_parent.json")
                    .read_text())
ITEMS = ["pool", "tail", "requests", "sample", "served", "work", "numbers",
         "control"]
PARENT_LESS = ("pool_seed", "schedule")


def _digest(x) -> str:
    h = hashlib.sha256()
    if isinstance(x, np.ndarray):
        h.update(str(x.dtype).encode() + str(x.shape).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, tuple):
        for a in x:
            h.update(_digest(a).encode())
    else:
        h.update(json.dumps(x).encode())
    return h.hexdigest()


def drive(name: str, cache, seed: int = SEED, batches: int = BATCHES,
          parent: bool = False):
    """A cell's system at the CPU's sizes, its first `batches` batches of
    client 0 served by the port and recorded: (system, cell, config,
    recorder, served counts); with `parent`, on the parent's parameters."""
    cell, config = tiny(name)
    if parent:
        for key in PARENT_LESS:
            cell.pop(key, None)
    system = files.load_kind(config["kind"]).System(config, cell, seed)
    where, _ = run.cached_index(config, "cpu", cache)
    idx = system.open(st, where, "cpu")
    system.ingest_tail(idx)
    reqs = system.requests(st)
    rec = system.recorder()
    served = np.zeros(len(reqs), np.int64)
    sends = traffic.client_batches(cell, seed, 0)
    for _ in range(batches):
        ids = next(sends)
        res = st.search_batch(idx, [reqs[i] for i in ids], device="cpu")
        np.add.at(served, ids, 1)
        for i, rs in zip(ids.tolist(), res):
            if rec.wants(i):
                rec.add(i, rs)
    return system, cell, config, rec, served


@pytest.fixture(scope="module")
def now(cache):
    """The golden items of both cells from today's harness."""
    out = {}
    for name in GOLDEN:
        system, cell, config, rec, served = drive(name, cache, parent=True)
        kind = files.load_kind(config["kind"])
        pool = system.pool
        out[name] = {
            "pool": _digest(pool if isinstance(pool, np.ndarray)
                            else [list(p) for p in pool]),
            "tail": _digest(kind.tail(cell, config, SEED)),
            "requests": _digest([repr(r) for r in system.reqs]),
            "sample": traffic.check_sample(cell, SEED).tolist(),
            "served": _digest(served),
            "work": system.work(served),
            "numbers": system.judge(rec, "cpu")[0],
            "control": system.judge(rec, "cpu", control=True)[0],
        }
    return out


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_a_kind_gives_what_the_harness_gave_before(name, item, now):
    assert now[name][item] == GOLDEN[name][item]


@pytest.mark.parametrize("kind", ["text", "vector"])
def test_load_kind_finds_a_kind_by_its_name(kind):
    mod = files.load_kind(kind)
    assert mod.KIND == kind
    for attr in ("TINY", "pool", "tail", "System"):
        assert hasattr(mod, attr), attr
    for method in ("build", "open", "ingest_tail", "requests", "readings",
                   "recorder", "work", "judge"):
        assert callable(getattr(mod.System, method)), method


def test_a_missing_kind_fails_with_its_path():
    with pytest.raises(SystemExit, match=r"kinds/nosuchkind\.py"):
        files.load_kind("nosuchkind")


def test_a_kind_file_must_name_its_kind(tmp_path, monkeypatch):
    (tmp_path / "kinds").mkdir()
    (tmp_path / "kinds" / "other.py").write_text('KIND = "text"\n')
    monkeypatch.setattr(files, "HERE", tmp_path)
    with pytest.raises(SystemExit, match="defines the kind 'text'"):
        files.load_kind("other")


def test_a_kind_dropped_in_runs_with_no_other_file_edited(tmp_path,
                                                          monkeypatch,
                                                          cache):
    """A copy of the benchmark with one more kind file, a configuration and
    a cell that name it: the run finds all three by name and is correct."""
    home = tmp_path / "bench_port"
    for sub in ("configs", "workloads", "metrics", "kinds"):
        shutil.copytree(files.HERE / sub, home / sub)
    src = (files.HERE / "kinds" / "text.py").read_text()
    assert src.count('KIND = "text"') == 1
    (home / "kinds" / "textcopy.py").write_text(
        src.replace('KIND = "text"', 'KIND = "textcopy"'))
    config = json.loads((home / "configs" / "wiki1m.json").read_text())
    config.update(name="wikicopy", kind="textcopy")
    (home / "configs" / "wikicopy.json").write_text(json.dumps(config))
    cell = json.loads(
        (home / "workloads" / "wiki1m.topkcount_b512.json").read_text())
    cell.update(name="wikicopy.topkcount_b64", config="wikicopy")
    (home / "workloads" / "wikicopy.topkcount_b64.json").write_text(
        json.dumps(cell))
    monkeypatch.setattr(files, "HERE", home)
    monkeypatch.setattr(files, "ROOT", tmp_path)
    assert files.load_kind("textcopy").KIND == "textcopy"
    cell, config = tiny("wikicopy.topkcount_b64")

    def build_here(config, device, cache):
        """The index built in this process: the build process that
        run.cached_index starts reads the checkout's own kinds/."""
        where = cache / f"{config['name']}-{run.cache_key(config)}"
        if not (where / "ready").is_file():
            where.mkdir(parents=True, exist_ok=True)
            files.load_kind(config["kind"]).System(config, None, 0).build(
                st, where, device)
            (where / "ready").write_text("built in the test\n")
        return where, 0.0
    monkeypatch.setattr(run, "cached_index", build_here)
    out = run.run_cell(cell, config, 2**31 + 79, 1.5, False, device="cpu",
                       cache=cache)
    assert out["correct"] is True and out["attempted"] > 0
    # kernel_us_per_query reads the card's trace, which the CPU has not
    assert set(out["metrics"]) == {"setup_s"}


def _tree(tmp_path, rel: str, text: str) -> Path:
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return p


@pytest.mark.parametrize("rel", ["bench_port/kinds/text.py",
                                 "bench_port/reference/bm25f.py",
                                 "bench_port/reference/shared.py",
                                 "bench_port/gen/corpus.py"])
def test_cache_key_follows_the_kind_and_the_references(rel, tmp_path,
                                                       monkeypatch):
    """The build reads its kind's file and saves what the references read:
    a change to either builds the index anew."""
    wiki = files.load_config("wiki1m")
    _tree(tmp_path, "bench_port/kinds/vector.py", "KIND = 'vector'\n")
    p = _tree(tmp_path, rel, "x = 1\n")
    monkeypatch.setattr(run, "ROOT", tmp_path)
    k1 = run.cache_key(wiki)
    p.write_text("x = 2\n")
    assert run.cache_key(wiki) != k1


def test_cache_key_ignores_another_kinds_file(tmp_path, monkeypatch):
    wiki = files.load_config("wiki1m")
    _tree(tmp_path, "bench_port/kinds/text.py", "KIND = 'text'\n")
    p = _tree(tmp_path, "bench_port/kinds/vector.py", "x = 1\n")
    monkeypatch.setattr(run, "ROOT", tmp_path)
    k1 = run.cache_key(wiki)
    p.write_text("x = 2\n")
    assert run.cache_key(wiki) == k1
