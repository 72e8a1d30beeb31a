"""The port's own host layer (seekstorm_tpu_torch's copies of the JAX
package's host modules) against the JAX package's, on the CPU.

  * The same documents, deletes and commits through both packages write
    byte-identical index files, with one and two shards (a seed batch
    that fixes the string-facet ordinals, one and two commits, a full
    64K-doc level and partial ones, deletes, string and numeric facet
    columns, the spelling dictionary and the completions).
    The one field that differs is a time: ``lexcache.npz`` is a zip
    archive (``np.savez``) whose headers record when each member was
    written, so that file is compared member by member, names and bytes.
    No file records a path.
  * An index written by either package opens in the other and gives the
    same pages.
  * The port's commit fills its frequent-word warmup cache, through the
    port's own search, with jax and seekstorm_tpu blocked.
  * The port builds the native library from the tracked headers without
    running native/gen_*.py, which import the JAX package.
  * Its trace hooks run torch.profiler.
"""

import os
import shutil
import subprocess
import time
import zipfile

import numpy as np
import pytest

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu.schema import BLOCK_SIZE
from test_torch_search import (BLOCK_JAX, QUERIES, ROOT, _create, _docs,
                               _Pair, _run_blocked, _to_port)
from test_wand import _Page

# files whose bytes record a time, and the field that does
TIME_FIELDS = {"lexcache.npz": "the date_time of each zip member"}


def _schema(pkg):
    return [
        pkg.SchemaField("title", pkg.FieldType.Text, stored=True,
                        indexed=True, boost=10.0, dictionary_source=True,
                        completion_source=True),
        pkg.SchemaField("body", pkg.FieldType.Text, indexed=True),
        pkg.SchemaField("brand", pkg.FieldType.String16, stored=True,
                        facet=True),
        pkg.SchemaField("price", pkg.FieldType.U16, stored=True, facet=True),
    ]


def _meta(pkg):
    return pkg.IndexMeta(
        frequent_words=pkg.FrequentwordType.English,
        spelling_correction=pkg.SpellingCorrection(
            max_dictionary_edit_distance=2, count_threshold=1),
        query_completion=pkg.QueryCompletion(max_completion_entries=10_000))


N_BRANDS = 9


def _facet_docs(n, seed):
    rng = np.random.default_rng(seed)
    docs = _docs(n, seed)
    for d, b, p in zip(docs, rng.integers(0, N_BRANDS, n),
                       rng.integers(0, 500, n)):
        d["title"] = "the " + d["title"]
        d["brand"] = f"brand{b}"
        d["price"] = int(p)
    return docs


def _seed_docs():
    """Fewer than 64 docs that name every brand in a fixed order."""
    docs = _facet_docs(N_BRANDS, 6)
    for b, d in enumerate(docs):
        d["brand"] = f"brand{b}"
    return docs


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """Both packages write their indexes with the native library, so the
    files compare like with like.  Test workers load the reference's
    library at once while collecting (ROADMAP C.5): a worker whose first
    `make` lost that race caches `_LIB = None` for good.  The port's
    locked build makes sure the library exists; a loader that cached None
    is sent to look again, which finds it."""
    from seekstorm_tpu import native as ref_native
    from seekstorm_tpu_torch import native as port_native

    assert port_native.build_library(ROOT / "native") is not None
    for mod in (ref_native, port_native):
        if mod._LIB is None:
            mod._TRIED = False
    assert ref_native.load() is not None and port_native.load() is not None


@pytest.fixture(scope="module", params=[1, 2], ids=["s1", "s2"])
def built(request, tmp_path_factory):
    """Both packages' indexes: a seed batch, BLOCK_SIZE + 3000 docs
    committed, deletes, 2000 more docs committed."""
    path = tmp_path_factory.mktemp("th")
    first = _facet_docs(BLOCK_SIZE + 3_000, 7)
    second = _facet_docs(2_000, 8)
    both = []
    for pkg in (st, pt):
        idx = _create(pkg, path, _schema(pkg), meta=_meta(pkg),
                      shard_count=request.param)
        # A string-facet value gets the next ordinal in the order ingest
        # reaches it.  Batches of 64 docs or more ingest on one thread per
        # shard, so with two shards that order, and with it
        # facet_tables.json and the facet columns, would follow thread
        # timing.  The seed batch, under 64 docs, ingests one doc after
        # another and fixes every brand's ordinal first; the later
        # batches only look them up.
        idx.index_documents(_seed_docs())
        idx.index_documents(first)
        idx.commit()
        idx.delete_documents(list(range(0, 60_000, 173)))
        idx.index_documents(second)
        idx.commit()
        both.append(idx)
    return _Pair(*both)


def _files(root):
    return {p.relative_to(root).as_posix(): p
            for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_same_files(ref, port):
    """Every file of the two index trees byte-identical (a zip archive that
    records times member by member).  Returns the file names."""
    assert ref.keys() == port.keys()
    for name, a in ref.items():
        b = port[name]
        if name.rsplit("/", 1)[-1] in TIME_FIELDS:
            with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
                assert za.namelist() == zb.namelist(), name
                for m in za.namelist():
                    assert za.read(m) == zb.read(m), (name, m)
        else:
            assert a.read_bytes() == b.read_bytes(), name
    return {k.rsplit("/", 1)[-1] for k in ref}


def test_committed_files_byte_identical(built):
    ref, port = _files(built.ref.path), _files(built.port.path)
    names = _assert_same_files(ref, port)
    assert {"lexcache.npz", "facet_tables.json", "dictionary.csv",
            "completions.csv", "deleted.npy"} <= names
    if built.shard_count == 1:
        assert "shard_0/level_1/level.json" in ref      # a full level


def _pages(search, idx, reqs):
    return [_Page(rs) for rs in search(idx, reqs)]


def test_index_opens_in_other_package(built):
    reqs = [st.SearchRequest(query=q, length=10,
                             result_type=st.ResultType.TopkCount)
            for q in QUERIES]
    preqs = _to_port(reqs)

    def port_search(idx, r):
        return pt.search_batch(idx, r, device="cpu")

    ref = _pages(st.search_batch, built.ref, reqs)
    port = _pages(port_search, built.port, preqs)
    assert port == ref
    assert _pages(st.search_batch, st.open_index(built.port.path),
                  reqs) == ref
    assert _pages(port_search, pt.open_index(built.ref.path, device="cpu"),
                  preqs) == ref
    assert sum(p.count > 0 for p in ref) > len(reqs) // 2


def _vector_meta(pkg, i8):
    return pkg.IndexMeta(vector=pkg.VectorConfig(
        enabled=True, dim=24, similarity=pkg.VectorSimilarity.Euclidean,
        precision=pkg.Precision.I8 if i8 else pkg.Precision.F32,
        quantization=(pkg.Quantization.ScalarQuantizationI8 if i8
                      else pkg.Quantization.Null),
        inference=pkg.InferenceType.External,
        clustering=pkg.ClusteringConfig(
            mode=pkg.ClusteringMode.Auto if i8 else pkg.ClusteringMode.Null,
            min_points=100)))


@pytest.mark.parametrize("i8", [True, False], ids=["i8_auto", "f32_null"])
def test_vector_files_byte_identical(tmp_path, i8):
    """External embeddings (a well-separated Gaussian mixture, one and two
    chunks a doc) with a text field through both packages, two shards, two
    commits and deletes: every file byte-identical, the vector files among
    them (i8 with Auto clustering, where the levels are clustered on each
    package's device; f32 unclustered); each index opens in the other
    package with the same vector pages."""
    rng = np.random.default_rng(31 + i8)
    centers = rng.standard_normal((12, 24)).astype(np.float32) * 5.0
    data = (centers[rng.integers(0, 12, 900)]
            + rng.standard_normal((900, 24))).astype(np.float32)
    docs = [{"vector": data[i] if i % 7 else [data[i], data[i] * 0.5],
             "title": f"w{i % 40:03d} w{i % 13:03d}"} for i in range(900)]
    both = []
    for pkg in (st, pt):
        schema = [pkg.SchemaField("vector", pkg.FieldType.Json,
                                  index_vector=True),
                  pkg.SchemaField("title", pkg.FieldType.Text, indexed=True,
                                  stored=True)]
        idx = _create(pkg, tmp_path, schema, meta=_vector_meta(pkg, i8),
                      shard_count=2)
        idx.index_documents(docs[:700])
        idx.commit()
        idx.delete_documents([3, 10, 500])
        idx.index_documents(docs[700:])
        idx.commit()
        both.append(idx)
    ref, port = _files(both[0].path), _files(both[1].path)
    names = _assert_same_files(ref, port)
    assert {"vec_data.npy", "vec_offsets.npy", "vec.json"} <= names
    lv = both[1].vectors.shards[0].levels[0]
    assert lv.clustered == i8 and lv.data.dtype == (np.int8 if i8
                                                    else np.float32)
    reqs = [st.SearchRequest(search_mode=st.SearchMode.Vector,
                             query_vector=data[i].tolist(), length=5,
                             ann_mode="Nprobe", nprobe=3)
            for i in range(0, 900, 97)]
    want = _pages(st.search_batch, both[0], reqs)
    assert _pages(st.search_batch, st.open_index(both[1].path), reqs) == want
    opened = pt.open_index(both[0].path, device="cpu")
    got = _pages(lambda idx, r: pt.search_batch(idx, r, device="cpu"),
                 opened, _to_port(reqs))
    assert [p.ids for p in got] == [p.ids for p in want]


_WARMUP = BLOCK_JAX + r"""
import seekstorm_tpu_torch as pt
from seekstorm_tpu_torch.utils import term_hash
idx = pt.create_index(
    sys.argv[1], [pt.SchemaField("t", pt.FieldType.Text, indexed=True)],
    meta=pt.IndexMeta(frequent_words=pt.FrequentwordType.English),
    device="cpu")
idx.index_documents([{"t": f"the w{i % 50} of w{i % 7}" + " the" * (i % 3)}
                     for i in range(3000)])
idx.commit()
assert len(idx._warmup_cache) >= 2, idx._warmup_cache.keys()
scores, gids, total, facets = idx._warmup_cache[term_hash("the")]
assert total == 3000 and len(gids) == 1000 and facets == {}
req = pt.SearchRequest(query="the", length=20, realtime=False)
n0 = pt.METRICS.snapshot().get("device_dispatch_total", 0)
cached = idx.search(req)
assert pt.METRICS.snapshot().get("device_dispatch_total", 0) == n0
idx._warmup_cache = {}
fresh = idx.search(req)
assert pt.METRICS.snapshot().get("device_dispatch_total", 0) > n0
assert cached.result_count_total == fresh.result_count_total == 3000
assert [(r.doc_id, r.score) for r in cached.results] == \
    [(r.doc_id, r.score) for r in fresh.results]
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "seekstorm_tpu")]
print("ok", len(gids))
"""


def test_port_commit_fills_warmup_without_jax(tmp_path):
    """Commit's frequent-word warmup runs through the port's search_batch:
    the cached page of a frequent word equals a fresh search's, and is
    served without a device dispatch."""
    out = _run_blocked(_WARMUP, str(tmp_path / "ix"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


_FAKE_CXX = """#!/bin/sh
# a compiler stand-in: logs its run, fails while FAIL_FIRST names a file
# that is not there yet (creating it), else writes the -o target
echo run >> "$CXX_LOG"
if [ -n "$FAIL_FIRST" ] && [ ! -e "$FAIL_FIRST" ]; then
    touch "$FAIL_FIRST"; exit 1
fi
sleep 0.3
while [ $# -gt 0 ]; do
    if [ "$1" = "-o" ]; then echo lib > "$2"; fi
    shift
done
"""


def _native_copy(tmp_path, monkeypatch, fail_first=False):
    """A native directory with the real sources and a stand-in compiler."""
    if shutil.which("make") is None:
        pytest.skip("make is not installed")
    nd = tmp_path / "native"
    nd.mkdir()
    for f in ("Makefile", "seekstorm_native.cpp", "snowball.cpp",
              "light_stemmers.cpp", "unicode_tables.h",
              "light_stemmer_tables.h"):
        shutil.copy(ROOT / "native" / f, nd / f)
    cxx = tmp_path / "cxx"
    cxx.write_text(_FAKE_CXX)
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setenv("CXX_LOG", str(tmp_path / "cxx.log"))
    if fail_first:
        monkeypatch.setenv("FAIL_FIRST", str(tmp_path / "failed_once"))
    return nd, tmp_path / "cxx.log"


def test_native_build_once_across_concurrent_callers(tmp_path, monkeypatch):
    """Four callers that find no library at once all get it, and the
    compiler runs once: they take a lock, and a caller that gets it after
    another finished takes that one's library (ROADMAP C: concurrent
    first-use builds in one native/ directory lost a worker its library)."""
    from concurrent.futures import ThreadPoolExecutor

    from seekstorm_tpu_torch import native

    nd, log = _native_copy(tmp_path, monkeypatch)
    with ThreadPoolExecutor(4) as ex:
        got = list(ex.map(lambda _: native.build_library(nd), range(4)))
    assert got == [nd / "libseekstorm_native.so"] * 4
    assert log.read_text().split() == ["run"]
    assert (nd / "libseekstorm_native.so").read_text() == "lib\n"
    assert not [p.name for p in nd.iterdir()
                if p.name.startswith(".build-") or p.name.endswith(".tmp")]


def test_native_build_retries_a_failed_compile(tmp_path, monkeypatch):
    """A compile that fails once (as when another process's make rewrote a
    header under it) is retried, so the process still gets its library."""
    from seekstorm_tpu_torch import native

    nd, log = _native_copy(tmp_path, monkeypatch, fail_first=True)
    assert native.build_library(nd) == nd / "libseekstorm_native.so"
    assert log.read_text().split() == ["run", "run"]


def test_native_build_runs_no_generator(tmp_path):
    """make_command compiles from the tracked headers even where the
    generators are newer, and refuses to build when a header is missing."""
    from seekstorm_tpu_torch import native

    if shutil.which("make") is None:
        pytest.skip("make is not installed")
    nd = tmp_path / "native"
    nd.mkdir()
    for f in ("Makefile", "seekstorm_native.cpp", "snowball.cpp",
              "light_stemmers.cpp", "unicode_tables.h",
              "light_stemmer_tables.h", "gen_tables.py",
              "gen_light_tables.py"):
        shutil.copy(ROOT / "native" / f, nd / f)
    (tmp_path / "seekstorm_tpu").mkdir()
    (tmp_path / "seekstorm_tpu" / "stemmers.py").touch()
    old = time.time() - 3600
    for h in ("unicode_tables.h", "light_stemmer_tables.h"):
        os.utime(nd / h, (old, old))
    plain = subprocess.run(["make", "-n", "-C", str(nd),
                            "libseekstorm_native.so"],
                           capture_output=True, text=True)
    assert "gen_tables.py" in plain.stdout     # make alone would run it
    cmd = native.make_command(nd)
    dry = subprocess.run(cmd + ["-n"], capture_output=True, text=True,
                         check=True)
    assert "gen_" not in dry.stdout and "seekstorm_native.cpp" in dry.stdout
    (nd / "unicode_tables.h").unlink()
    with pytest.raises(RuntimeError, match="unicode_tables.h"):
        native.make_command(nd)


def test_trace_hooks_use_torch_profiler(tmp_path):
    """metrics.start_trace/stop_trace drive torch.profiler (the reference
    drives jax.profiler): one trace at a time, written on stop."""
    from seekstorm_tpu_torch import metrics

    assert metrics.start_trace(str(tmp_path)) is True
    assert metrics.start_trace(str(tmp_path)) is False
    pt.search_batch(pt.create_index(tmp_path / "ix", [pt.SchemaField(
        "t", pt.FieldType.Text, indexed=True)], device="cpu"),
        [pt.SearchRequest(query="x")], device="cpu")
    assert metrics.stop_trace() is True
    assert metrics.stop_trace() is False
    assert list(tmp_path.glob("*.pt.trace.json"))
