"""The harness end to end on the CPU at a tiny size: the result line, the
import guard, the control and planted faults coming out not correct, the
cache left as found, and cells, configurations and metrics found by their
files alone."""

import json
import shutil

import pytest
import torch

import run
from conftest import tiny
from harness import files

CELLS = sorted(p.stem for p in (files.HERE / "workloads").glob("*.json"))
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, cache, **kw):
    cell, config = tiny(name)
    kw.setdefault("seconds", 1.5)
    kw.setdefault("trace", False)
    return run.run_cell(cell, config, 2**31 + 77, device="cpu",
                        cache=cache, **kw)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_dry_run_line_has_the_contract_keys(name, trace, cache):
    out = _run(name, cache, trace=trace)
    keys = list(out)
    assert keys[:5] == CONTRACT and keys[-1] == "check"
    assert set(keys) == set(CONTRACT) | {"index_build_s", "check"} | (
        {"breakdown"} if trace else set())
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    for v in out["check"].values():
        assert set(v) == {"value", "limit"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = files.load_cell(name)
    mods = files.metric_modules()
    if not trace:
        # the CPU records no device trace: an end-to-end metric read from
        # it reads nothing here
        assert set(out["metrics"]) == {
            n for n in cell["end_to_end"]
            if mods[n].SOURCE != "device_trace"}
    else:
        assert {"busy_s", "window_s"} <= set(out["device"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(out)


def test_the_run_leaves_the_cache_as_found(cache):
    out = _run(CELLS[0], cache)
    assert out["check"]["cache_changed"]["value"] == 0
    idx_dir = next(cache.glob(f"{tiny(CELLS[0])[0]['config']}-*")) / "index"
    before = run.snapshot(idx_dir)
    _run(CELLS[0], cache)
    assert run.snapshot(idx_dir) == before


def test_the_index_build_is_reported_apart_from_setup(tmp_path):
    cell, config = tiny("sift1m.nprobe16_b64")
    first = run.run_cell(cell, config, 2**31 + 78, 1.0, False, device="cpu",
                         cache=tmp_path)
    again = run.run_cell(cell, config, 2**31 + 78, 1.0, False, device="cpu",
                         cache=tmp_path)
    assert first["index_build_s"] > 0 and again["index_build_s"] == 0
    # the build took place in a child before the window; setup_s is what
    # the process itself spent
    assert first["metrics"]["setup_s"]["value"] > 0
    assert list(first)[-2:] == ["index_build_s", "check"]


def test_the_build_process_fails_on_forbidden_modules(tmp_path,
                                                       monkeypatch):
    _, config = tiny("sift1m.nprobe16_b64")
    config["n_vectors"] = 2_000
    monkeypatch.setattr(run, "forbidden_modules", lambda: ["jax"])
    assert run.build(config, "cpu", tmp_path) != 0
    assert not (tmp_path / "ready").exists()


def test_a_missing_span_target_fails_the_traced_run(monkeypatch):
    from harness import trace

    import seekstorm_tpu_torch as st
    monkeypatch.setattr(trace, "SPANS", trace.SPANS + [
        ("seekstorm_tpu_torch.search", "_gone_from_the_port", "gone")])
    tr = trace.Trace(torch, st.METRICS)
    with pytest.raises(RuntimeError, match="_gone_from_the_port"):
        tr.start()
    assert tr.prof is None and not tr._undo


def test_cache_key_follows_the_configuration_and_sources(monkeypatch,
                                                         tmp_path):
    wiki, sift = files.load_config("wiki1m"), files.load_config("sift1m")
    key = run.cache_key(wiki)
    assert key == run.cache_key(dict(wiki)) != run.cache_key(sift)
    assert run.cache_key(dict(wiki, n_docs=1000)) != key
    src = tmp_path / "seekstorm_tpu_torch"
    src.mkdir()
    (src / "search.py").write_text("x = 1\n")
    monkeypatch.setattr(run, "ROOT", tmp_path)
    k1 = run.cache_key(wiki)
    (src / "search.py").write_text("x = 2\n")
    assert run.cache_key(wiki) != k1


@pytest.mark.parametrize("modules,bad", [
    ({"jax": 1, "numpy": 1}, ["jax"]),
    ({"jax.numpy": 1}, ["jax.numpy"]),
    ({"seekstorm_tpu": 1}, ["seekstorm_tpu"]),
    ({"seekstorm_tpu.ops.wand": 1}, ["seekstorm_tpu.ops.wand"]),
    ({"flax.linen": 1, "jaxlib": 1}, ["flax.linen", "jaxlib"]),
    ({"seekstorm_tpu_torch": 1, "seekstorm_tpu_torch.search": 1,
      "jaxtyping": 1}, []),
])
def test_import_guard_compares_whole_top_level_names(modules, bad):
    assert run.forbidden_modules(modules) == bad


def test_import_guard_passes_this_process():
    import seekstorm_tpu_torch  # noqa: F401
    assert run.forbidden_modules() == []


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, cache):
    out = _run(name, cache, control=True)
    assert out["correct"] is False
    first = next(iter(out["check"]))
    assert out["check"][first]["value"] > out["check"][first]["limit"]


def _altered(search):
    def wrapped(batch):
        res = search(batch)
        for rs in res:
            if rs.results:
                rs.results[0].doc_id += 1
                break
        return res
    return wrapped


def _half_left_out(search):
    from seekstorm_tpu_torch import ResultSet

    def wrapped(batch):
        half = len(batch) // 2
        return search(batch[:half]) + [ResultSet() for _ in batch[half:]]
    return wrapped


FAULTS = [_altered, _half_left_out]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, which, cache):
    """The answer altered where it is produced, or half of the batch left
    out."""
    assert _run(name, cache, fault=FAULTS[which])["correct"] is False


def test_files_dropped_in_are_found(tmp_path, monkeypatch, cache):
    home = tmp_path / "bench_port"
    for sub in ("configs", "workloads", "metrics", "kinds"):
        shutil.copytree(files.HERE / sub, home / sub)
    config = json.loads((home / "configs" / "wiki1m.json").read_text())
    config["name"] = "wikismall"
    (home / "configs" / "wikismall.json").write_text(json.dumps(config))
    cell = json.loads(
        (home / "workloads" / "wiki1m.topkcount_b512.json").read_text())
    cell.update(name="wikismall.topk_b64", config="wikismall",
                request={"result_type": "Topk", "length": 10,
                         "realtime": True})
    (home / "workloads" / "wikismall.topk_b64.json").write_text(
        json.dumps(cell))
    (home / "metrics" / "demo.batches.py").write_text(
        'NAME = "demo.batches"\nUNIT = "1"\nBETTER = "higher"\n'
        'SOURCE = "host_clock"\nLAYER = "client"\nMOVES = "qps"\n\n'
        'def read(run):\n    return len(run.run["latencies"])\n')
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({"per_layer": [
        {"name": "demo.batches", "moves": "qps",
         "workloads": ["wikismall.topk_b64"]}]}))
    monkeypatch.setattr(files, "HERE", home)
    monkeypatch.setattr(files, "ROOT", tmp_path)
    assert files.load_config("wikismall")["name"] == "wikismall"
    assert "demo.batches" in files.metric_modules()
    out = _run("wikismall.topk_b64", cache, trace=True)
    assert out["correct"] is True
    assert list(out["metrics"]) == ["demo.batches"]
    assert out["metrics"]["demo.batches"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_on_the_card(name, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    assert run.main(["--workload", name, "--seed", "2147483700",
                     "--seconds", "5"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
