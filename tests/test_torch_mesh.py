"""Multi-device search of the torch port (``Index.attach_mesh`` over a list
of torch devices) on the CPU against the JAX package's mesh.

Each counterpart of ``tests/test_mesh.py`` and of
``tests/test_qt.py::test_qt_sharded_mesh`` builds both packages on the same
documents: the reference attaches its mesh over the 8 virtual CPU devices
(``tests/conftest.py``), the port a mesh of repeated ``"cpu"`` devices.  The
port's mesh pages are held to the reference's mesh: ids, order and counts
equal, scores within the reference test's rtol 1e-5; and to the port's own
pages without a mesh (exactly on the dense and join routes, by
``test_wand._Page`` on the WAND route).  The dry run's case
(``__graft_entry__.py::dryrun_multichip``) is held to the numbers of
``MULTICHIP_r05.json``.  Unit tests hold ``merge_mesh`` to the reference's
``_merge_body``, the mesh WAND dispatch with its hooked device ladder to
``make_wand_scan_mesh`` on the same pools, and two positions on one device
to separate states.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu.parallel.mesh import _merge_body
from seekstorm_tpu.parallel.mesh import make_mesh as ref_mesh
from seekstorm_tpu_torch.ops import wand as pw
from seekstorm_tpu_torch.parallel import mesh as pmesh
from test_lexical import BruteForce, assert_parity, make_docs
from test_torch_search import _to_port
from test_wand import _Page

wand_mod = importlib.import_module("seekstorm_tpu.ops.wand")
ps = importlib.import_module("seekstorm_tpu_torch.search")
plan_mod = importlib.import_module("seekstorm_tpu_torch.plan")
rs_mod = importlib.import_module("seekstorm_tpu.search")

RTOL = 1e-5          # the reference mesh tests' score tolerance
QUERIES = [
    ("w001 w004", "Union"), ("w002 w003", "Intersection"),
    ("w000", "Union"), ("+w001 w005", "Union"),
    ("-w000 w001 w002", "Union"), ("w004 w005 w006", "Union"),
    ("w001 w002", "Intersection"), ("w007 w011", "Union"),
]


def _std(pkg):
    return [pkg.SchemaField("title", pkg.FieldType.Text, stored=True,
                            indexed=True, boost=10.0),
            pkg.SchemaField("body", pkg.FieldType.Text, stored=True,
                            indexed=True)]


def _make(pkg, path, docs, shards, schema=_std, meta=None, commits=1):
    kw = {"device": "cpu"} if pkg is pt else {}
    if meta is not None:
        kw["meta"] = meta(pkg)
    idx = pkg.create_index(path, schema(pkg), shard_count=shards, **kw)
    step = -(-len(docs) // commits)
    for a in range(0, len(docs), step):
        idx.index_documents(docs[a:a + step])
        idx.commit()
    return idx


def _trio(path, docs, shards, port_devices, **kw):
    """(reference with its mesh attached, port without a mesh, port with a
    mesh of `port_devices`), all from `docs`."""
    ref = _make(st, path / "ref", docs, shards, **kw)
    ref.attach_mesh()
    plain = _make(pt, path / "plain", docs, shards, **kw)
    meshed = _make(pt, path / "mesh", docs, shards, **kw)
    meshed.attach_mesh(pt.make_mesh(port_devices))
    return types.SimpleNamespace(ref=ref, plain=plain, mesh=meshed,
                                 docs=docs)


def _requests(queries, **kw):
    kw.setdefault("length", 10)
    kw.setdefault("result_type", st.ResultType.TopkCount)
    kw.setdefault("realtime", False)
    return [st.SearchRequest(query=q, query_type_default=st.QueryType(ty),
                             **kw) for q, ty in queries]


def _ref(idx, reqs):
    return st.search_batch(idx, reqs)


def _port(idx, reqs):
    return pt.search_batch(idx, _to_port(reqs), device="cpu")


def _assert_same(want, got, exact_scores=False):
    """Pages equal: ids, order and counts exactly; scores within RTOL (or
    bit for bit)."""
    for a, b in zip(want, got, strict=True):
        assert [r.doc_id for r in b.results] == [r.doc_id for r in a.results]
        assert b.result_count_total == a.result_count_total
        sa = np.array([r.score for r in a.results], np.float64)
        sb = np.array([r.score for r in b.results], np.float64)
        if exact_scores:
            np.testing.assert_array_equal(sb, sa)
        else:
            np.testing.assert_allclose(sb, sa, rtol=RTOL)


class _PortView:
    """The port index behind the reference's request types (for
    test_lexical.assert_parity)."""

    def __init__(self, idx):
        self.idx = idx

    def search(self, req):
        return _port(self.idx, [req])[0]


@pytest.fixture
def route(monkeypatch):
    """Sets a route's switches for both packages."""
    def set_(name):
        for k in ("SEEKSTORM_TPU_WAND", "SEEKSTORM_TPU_NO_WAND",
                  "SEEKSTORM_TPU_JOIN"):
            monkeypatch.delenv(k, raising=False)
        env = {"wand": {"SEEKSTORM_TPU_WAND": "1"},
               "dense": {"SEEKSTORM_TPU_NO_WAND": "1",
                         "SEEKSTORM_TPU_JOIN": "0"},
               "join": {"SEEKSTORM_TPU_NO_WAND": "1",
                        "SEEKSTORM_TPU_JOIN": "1"}}[name]
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    return set_


@pytest.fixture(scope="module")
def lex(tmp_path_factory):
    """8 shards of make_docs (3 commits, one block a shard): the reference
    on its 8-device mesh, the port without a mesh and on ["cpu"] * 8."""
    docs = make_docs(np.random.default_rng(21), 900)
    return _trio(tmp_path_factory.mktemp("mesh"), docs, 8, ["cpu"] * 8,
                 commits=3)


# ---------------------------------------------------------------------------
# counterparts of tests/test_mesh.py


def test_mesh_matches_single_device(lex):
    assert jax.device_count() == 8
    assert lex.ref._mesh.devices.size == 8
    assert lex.mesh._mesh.devices.size == 8
    reqs = _requests(QUERIES)
    plain = _port(lex.plain, reqs)
    meshed = _port(lex.mesh, reqs)
    _assert_same(plain, meshed, exact_scores=True)
    _assert_same(_ref(lex.ref, reqs), meshed)
    bf = BruteForce(lex.ref, lex.docs)
    assert_parity(_PortView(lex.mesh), bf, "w002 w003", "Union")
    assert_parity(_PortView(lex.mesh), bf, "w001 w002", "Intersection")


@pytest.mark.parametrize("name", ["dense", "join"])
def test_mesh_routes_match_single_device(lex, route, name):
    """The dense route (K2's pair scan once a position) and the join route
    (a Topk batch) through the mesh: the port's own pages exactly, and the
    reference mesh's."""
    route(name)
    rtype = st.ResultType.Topk if name == "join" else st.ResultType.TopkCount
    reqs = _requests(QUERIES, result_type=rtype)
    meshed = _port(lex.mesh, reqs)
    _assert_same(_port(lex.plain, reqs), meshed, exact_scores=True)
    _assert_same(_ref(lex.ref, reqs), meshed)


def test_mesh_uneven_devices(tmp_path):
    """6 shards: the divisor rule (one "cpu" on the CPU) and a mesh of 6."""
    docs = make_docs(np.random.default_rng(22), 120)
    t = _trio(tmp_path, docs, 6, ["cpu"] * 6)
    assert t.ref._mesh.devices.size == 6
    t.plain.attach_mesh()
    assert [str(d) for d in t.plain._mesh.devices] == ["cpu"]
    reqs = _requests([("w000 w001", "Union")])
    _assert_same(_ref(t.ref, reqs), _port(t.mesh, reqs))
    _assert_same(_port(t.plain, reqs), _port(t.mesh, reqs),
                 exact_scores=True)
    bf = BruteForce(t.ref, docs)
    assert_parity(_PortView(t.mesh), bf, "w000 w001", "Union")
    with pytest.raises(ValueError):
        t.mesh.attach_mesh(pt.make_mesh(["cpu"] * 4))


def test_mesh_dense_term_path(tmp_path, monkeypatch):
    """Dense-term rows (the bitmap row scoring) through the mesh."""
    for name in ("seekstorm_tpu.lexindex", "seekstorm_tpu_torch.lexindex"):
        monkeypatch.setattr(importlib.import_module(name), "DENSE_MIN", 16)
    rng = np.random.default_rng(23)
    docs = []
    for _ in range(400):
        w = ["common"] * int(rng.integers(1, 3))
        w += [f"rare{int(rng.integers(0, 30))}" for _ in range(5)]
        rng.shuffle(w)
        docs.append({"t": " ".join(w)})

    def schema(pkg):
        return [pkg.SchemaField("t", pkg.FieldType.Text, stored=True,
                                indexed=True)]

    t = _trio(tmp_path, docs, 8, ["cpu"] * 8, schema=schema)
    assert any(len(sh.lexical.dense_tf) for sh in t.mesh.shards)
    queries = [("common", "Union"), ("common rare3", "Union"),
               ("+common +rare5", "Union"), ("common -rare7", "Union")]
    reqs = _requests(queries, length=50)
    meshed = _port(t.mesh, reqs)
    _assert_same(_port(t.plain, reqs), meshed, exact_scores=True)
    _assert_same(_ref(t.ref, reqs), meshed)


def test_mesh_throughput_shape_divides(lex, route, monkeypatch):
    """8 shards over 8 positions: a position's work is its shard's blocks,
    its arrays hold its shard alone, and a batch is one dispatch with one
    pair scan a position."""
    route("dense")
    per_shard = [sh.lexical.n_blocks for sh in lex.mesh.shards]
    total = sum(per_shard)
    assert all(b == total // 8 for b in per_shard), per_shard
    stacked = pmesh.get_stacked(lex.mesh, "cpu")
    assert isinstance(stacked, pmesh.MeshStacked)
    assert [p.shard_ids for p in stacked.positions] == [[s] for s in
                                                         range(8)]
    for p, sh in zip(stacked.positions, lex.mesh.shards):
        assert p.n_postings == len(sh.lexical.dev_docid)
        assert p.nblk == sh.lexical.n_blocks
    scans = []
    orig = pmesh.StackedIndex.scan
    monkeypatch.setattr(pmesh.StackedIndex, "scan",
                        lambda self, *a, **kw: scans.append(self)
                        or orig(self, *a, **kw))
    before = pt.METRICS._counters.get("device_dispatch_total", 0)
    reqs = _requests([("w001 w004", "Union")] * 16)
    _port(lex.mesh, reqs)
    after = pt.METRICS._counters.get("device_dispatch_total", 0)
    assert after - before == 1, (before, after)
    assert scans == stacked.positions


def test_mesh_wand_matches_single_device(lex, route):
    """The WAND engine under the mesh: each position scans its own blocks,
    the rung tops merge on the lead device, the positions rescore their own
    buckets; pages and counts equal the port's one-device WAND pages and
    dense pages (by _Page) and the reference mesh's."""
    reqs = _requests(QUERIES)
    route("wand")
    single = [_Page(r) for r in _port(lex.plain, reqs)]
    route("dense")
    assert [_Page(r) for r in _port(lex.plain, reqs)] == single
    route("wand")
    meshed = _port(lex.mesh, reqs)
    assert [_Page(r) for r in meshed] == single
    _assert_same(_ref(lex.ref, reqs), meshed)

    state = pw.get_state(lex.mesh, "cpu")
    assert state.mesh is lex.mesh._mesh and state.D == 8
    assert len(state.parts) == 8 and state.nblk_local == 1
    assert [p.b0 for p in state.parts] == list(range(8))
    # every position holds pool rows of its own block
    assert all(n > 0 for n in state.n_prows), state.n_prows


def test_mesh_wand_count_only(lex, route):
    """ResultType.Count under the mesh: the positions' summed phase-1
    popcounts are the answer."""
    route("wand")
    bf = BruteForce(lex.ref, lex.docs)
    reqs = _requests([("w001 w002", "Union"), ("w001 w002", "Intersection")],
                     result_type=st.ResultType.Count)
    got = _port(lex.mesh, reqs)
    want = _ref(lex.ref, reqs)
    for (q, ty), a, b in zip([("w001 w002", "Union"),
                              ("w001 w002", "Intersection")], want, got):
        assert b.result_count_total == a.result_count_total \
            == len(bf.score(q, ty))


def test_mesh_multiple_shards_per_device(tmp_path):
    """16 shards over 8 positions: each position scans both of its shards."""
    docs = make_docs(np.random.default_rng(24), 800)
    t = _trio(tmp_path, docs, 16, ["cpu"] * 8)
    assert t.ref._mesh.devices.size == 8
    stacked = pmesh.get_stacked(t.mesh, "cpu")
    assert [p.shard_ids for p in stacked.positions] == [
        [2 * d, 2 * d + 1] for d in range(8)]
    queries = [("w001 w004", "Union"), ("w001 w002", "Intersection"),
               ("w000", "Union")]
    reqs = _requests(queries, realtime=True)
    meshed = _port(t.mesh, reqs)
    _assert_same(_port(t.plain, reqs), meshed, exact_scores=True)
    _assert_same(_ref(t.ref, reqs), meshed)
    bf = BruteForce(t.ref, docs)
    for q, ty in queries:
        assert_parity(_PortView(t.mesh), bf, q, ty)


def _vec_meta(pkg, d, similarity, **cl):
    return pkg.IndexMeta(vector=pkg.VectorConfig(
        enabled=True, dim=d, similarity=pkg.VectorSimilarity[similarity],
        precision=pkg.Precision.I8,
        quantization=pkg.Quantization.ScalarQuantizationI8,
        inference=pkg.InferenceType.External,
        clustering=pkg.ClusteringConfig(**{
            "mode": pkg.ClusteringMode[cl.get("mode", "Auto")],
            "min_points": cl.get("min_points", 100)})))


def test_mesh_vector_matches_single_device(tmp_path):
    """Vector search under the mesh: one medoid pass and one scan pass over
    the positions' shards; pages, scores and the observed counters
    equal the port's one-device pages and the reference mesh's."""
    rng = np.random.default_rng(25)
    n, d, n_centers = 1600, 32, 20
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 5.0
    data = (centers[rng.integers(0, n_centers, size=n)]
            + rng.standard_normal((n, d))).astype(np.float32)
    queries = (centers[rng.integers(0, n_centers, size=4)]
               + rng.standard_normal((4, d))).astype(np.float32)

    def schema(pkg):
        return [pkg.SchemaField("vector", pkg.FieldType.Json,
                                index_vector=True),
                pkg.SchemaField("label", pkg.FieldType.Text, stored=True)]

    docs = [{"vector": data[i].tolist(), "label": str(i)} for i in range(n)]
    t = _trio(tmp_path, docs, 8, ["cpu"] * 8, schema=schema,
              meta=lambda pkg: _vec_meta(pkg, d, "Euclidean",
                                         min_points=50))
    # one query a search, as the reference's test (the reference's gathered
    # scan on the CPU changes its fma order at some batch sizes, see
    # ops/vector.py; at one query the port's scores are its bit for bit)
    for q in queries:
        for mode, np_ in [("All", 0), ("Nprobe", 4)]:
            reqs = [st.SearchRequest(search_mode=st.SearchMode.Vector,
                                     query_vector=q.tolist(), length=10,
                                     ann_mode=mode, nprobe=np_,
                                     realtime=False)]
            got = _port(t.mesh, reqs)
            for want in (_port(t.plain, reqs), _ref(t.ref, reqs)):
                _assert_same(want, got, exact_scores=True)
                a, b = want[0], got[0]
                assert (a.observed_vector_count, a.observed_cluster_count) \
                    == (b.observed_vector_count, b.observed_cluster_count)
                assert a.observed_vector_count > 0
    dev = t.mesh.vectors.device_stacked(t.mesh._mesh)
    assert len(dev["positions"]) == 8
    assert all(len(p["shards"]) == 1 for p in dev["positions"])
    # the positions hold the shards' one device copy
    again = t.mesh.vectors.device_stacked(t.mesh._mesh)
    assert all(a["data"] is b["data"] and a["data"] is h["data"]
               for a, b, h in zip(dev["per_shard"], again["per_shard"],
                                  [t.mesh.vectors.device(sh, "cpu")
                                   for sh in t.mesh.shards]))


def test_mesh_hybrid_rrf(tmp_path):
    """Hybrid under the mesh: both engines on the positions, fused as on
    one device."""
    rng = np.random.default_rng(26)
    d = 16
    vocab = [f"w{i:03d}" for i in range(40)]
    docs = [{"title": " ".join(rng.choice(vocab, 8)),
             "vector": rng.standard_normal(d).astype(np.float32).tolist()}
            for _ in range(320)]

    def schema(pkg):
        return [pkg.SchemaField("title", pkg.FieldType.Text, stored=True,
                                indexed=True),
                pkg.SchemaField("vector", pkg.FieldType.Json,
                                index_vector=True)]

    t = _trio(tmp_path, docs, 8, ["cpu"] * 8, schema=schema,
              meta=lambda pkg: _vec_meta(pkg, d, "Cosine"))
    q = rng.standard_normal(d).astype(np.float32).tolist()
    reqs = [st.SearchRequest(query="w001 w002",
                             search_mode=st.SearchMode.Hybrid,
                             query_vector=q, length=10, realtime=False)]
    meshed = _port(t.mesh, reqs)
    _assert_same(_port(t.plain, reqs), meshed, exact_scores=True)
    _assert_same(_ref(t.ref, reqs), meshed, exact_scores=True)


# ---------------------------------------------------------------------------
# tests/test_qt.py::test_qt_sharded_mesh and the dry run


def test_qt_sharded_mesh(lex, route, monkeypatch):
    """Pruned (query-tiled) plans of Topk batches through the mesh."""
    route("dense")
    rng = np.random.default_rng(9)
    vocab = [f"w{i:03d}" for i in range(60)]
    queries = [(f"{rng.choice(vocab)} {rng.choice(vocab)}", "Union")
               for _ in range(16)]
    reqs = _requests(queries, result_type=st.ResultType.Topk)
    base = _port(lex.plain, reqs)
    monkeypatch.setattr(plan_mod, "QT_MIN_BLOCKS", 1)
    monkeypatch.setattr(rs_mod, "QT_MIN_BLOCKS", 1)
    meshed = _port(lex.mesh, reqs)
    _assert_same(base, meshed, exact_scores=True)
    _assert_same(_ref(lex.ref, reqs), meshed)


def test_dryrun_multichip(tmp_path, monkeypatch):
    """__graft_entry__.py::dryrun_multichip(8) through the port: 32 shards
    over 8 positions (4 WAND blocks each), a hybrid, an AND and an OR
    request on the WAND route, equal to the unmeshed index and to the
    record in MULTICHIP_r05.json (hybrid top 882, AND count 160, OR count
    710, pool rows on all 8 positions)."""
    monkeypatch.setenv("SEEKSTORM_TPU_WAND", "1")
    d = 32
    rng = np.random.default_rng(1)
    vocab = [f"w{i:02d}" for i in range(40)]
    docs = [{"title": " ".join(rng.choice(vocab, size=4)),
             "body": " ".join(rng.choice(vocab, size=12)),
             "vector": rng.standard_normal(d).astype(np.float32).tolist()}
            for _ in range(40 * 32)]
    q = rng.standard_normal(d).astype(np.float32).tolist()

    def schema(pkg):
        return _std(pkg) + [pkg.SchemaField("vector", pkg.FieldType.Json,
                                            index_vector=True)]

    idx = _make(pt, tmp_path / "ix", docs, 32, schema=schema,
                meta=lambda pkg: _vec_meta(pkg, d, "Cosine", mode="Null"))
    reqs = [
        pt.SearchRequest(query="w01 w03", search_mode=pt.SearchMode.Hybrid,
                         query_vector=q, length=10),
        pt.SearchRequest(query="w01 w03",
                         query_type_default=pt.QueryType.Intersection,
                         result_type=pt.ResultType.TopkCount),
        pt.SearchRequest(query="w02 w05", result_type=pt.ResultType.TopkCount,
                         length=10)]

    def page(rs):
        return ([(r.doc_id, round(float(r.score), 4)) for r in rs.results],
                rs.result_count_total)

    want = [page(pt.search(idx, r, device="cpu")) for r in reqs]
    idx.attach_mesh(pt.make_mesh(["cpu"] * 8))
    got = [pt.search(idx, r, device="cpu") for r in reqs]
    assert [page(r) for r in got] == want
    assert got[0].results[0].doc_id == 882
    assert got[1].count_exact and got[1].result_count_total == 160
    assert got[2].result_count_total == 710
    ws = pw.get_state(idx, "cpu")
    assert ws.D == 8 and ws.nblk == 32 and ws.nblk_local == 4
    assert all(n > 0 for n in ws.n_prows), ws.n_prows
    dev = idx.vectors.device_stacked(idx._mesh)
    assert [len(p["shards"]) for p in dev["positions"]] == [4] * 8


# ---------------------------------------------------------------------------
# units


def test_merge_mesh_matches_merge_body():
    """merge_mesh against the reference's _merge_body in a shard_map over
    the 8 devices, with scores drawn from a few values so that tie classes
    span positions (and the page cuts through them)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    D, SL, B, k, S = 8, 2, 5, 6, 16
    rng = np.random.default_rng(27)
    ts = rng.choice(np.array([1.0, 2.0, 2.5, -np.inf], np.float32),
                    size=(D, SL, B, k)).astype(np.float32)
    ts = -np.sort(-ts, axis=-1)
    ti = rng.integers(0, 1000, size=(D, SL, B, k)).astype(np.int32)
    cnt = rng.integers(0, 50, size=(D, SL, B)).astype(np.int32)
    fc = rng.integers(0, 9, size=(D, SL, 1, B, 3)).astype(np.float32)

    def body(ts, ti, cnt, fc):
        return _merge_body([(ts[0, j], ti[0, j], cnt[0, j], fc[0, j])
                            for j in range(SL)], S, k)

    fn = shard_map(body, mesh=ref_mesh(D), in_specs=(P("shards"),) * 4,
                   out_specs=(P("shards"), P("shards")), check_vma=False)
    f32, i32 = [np.asarray(x)[0] for x in fn(
        jnp.asarray(ts), jnp.asarray(ti), jnp.asarray(cnt), jnp.asarray(fc))]

    gid = ti.astype(np.int64) * S + (np.arange(D)[:, None, None, None] * SL
                                     + np.arange(SL)[None, :, None, None])
    parts = [(torch.from_numpy(ts[d]), torch.from_numpy(gid[d]),
              torch.from_numpy(cnt[d].sum(0)),
              torch.from_numpy(fc[d].sum(0).astype(np.int64)))
             for d in range(D)]
    mts, mgid, mcnt, mfc = pmesh.merge_mesh(parts, k, torch.device("cpu"))
    np.testing.assert_array_equal(mts.numpy(), f32[:, :k])
    np.testing.assert_array_equal(mgid.numpy(), i32[:, :k])
    np.testing.assert_array_equal(mcnt.numpy(), i32[:, k])
    np.testing.assert_array_equal(
        mfc.numpy().transpose(1, 0, 2).reshape(B, -1), f32[:, k:])
    # the planted ties cross positions inside the page
    assert any(len(set(mgid.numpy()[b] % S // SL)) > 1 for b in range(B))


@pytest.mark.parametrize("need,multi", [(10, False), (10, True)])
def test_mesh_ladder_matches_reference(lex, need, multi):
    """wand_scan_mesh with its hooked _ladder_device against the reference's
    make_wand_scan_mesh on the same pools (the reference's mesh WandState
    carried across a position at a time) and the same batch tables: the
    slim buffer's counts, codes, found counts, rung ids and bounds exactly,
    the D*P_PAGE page scores within 3e-7 (the host chain rounds twice where
    XLA may contract) and their lanes exactly."""
    queries = [q for q, _ in QUERIES] + ["w003 w009", "w010", "w001 w013"]
    slots, specs = ps._build_specs(lex.plain, queries,
                                   [pt.QueryType.Union] * len(queries))
    idf = np.stack([ps._shard_idf(sh, slots, False)
                    for sh in lex.plain.shards])
    state = pw.WandState(lex.plain, "cpu")
    with state.lock:
        slotmap, tslot, treq, tneg, wsh, _ = pw.plan_batch(
            state, slots, specs, idf)
    used = sorted({s for sp in specs for s in sp.slots})
    js = wand_mod.WandState(lex.ref, ref_mesh(8))
    js.ensure_slots([slots[s].hash for s in used])
    nl = js.nblk_local
    pp, vp, rp, ip, prow, ioff, delw, sid = [
        np.asarray(x) for x in (js.ppool, js.vpool, js.rpool, js.ipool,
                                js.sp_prow, js.sp_ioff, js.delw_dev,
                                js.sid_dev)]
    pools = [pw.pools_from_numpy(pp[d], vp[d], rp[d], ip[d],
                                 prow[:, d * nl:(d + 1) * nl],
                                 ioff[:, d * nl:(d + 1) * nl],
                                 delw[d * nl:(d + 1) * nl],
                                 sid[d * nl:(d + 1) * nl], device="cpu")
             for d in range(8)]
    lead = types.SimpleNamespace(device=torch.device("cpu"), nblk_local=nl)
    out, _ = pw.wand_scan_mesh(lead, pools, (slotmap, tslot, treq, tneg, wsh),
                               with_counts=True, with_rescore=True,
                               need=need, multi=multi)
    out = out.numpy()
    Bq, T = tslot.shape
    from seekstorm_tpu.ops import wand_pallas

    statics = dict(V=len(slotmap), Bq=Bq, T=T, S=8, with_counts=True, NF=0,
                   FCM=1, with_filter=False, rank_by_key=False,
                   with_three=T > 2, BS=js.bstep,
                   PALLAS=wand_pallas.pallas_mode(0, False, T),
                   with_rescore=True, NEED=need, MULTI=multi)
    qargs = wand_mod._pack_qargs(slotmap, tslot, treq, tneg, wsh)
    ref, _ = wand_mod._dispatch_scan(
        js, (js.ppool, js.vpool, js.rpool, js.ipool, js.sp_prow, js.sp_ioff,
             js.delw_dev, js.sid_dev, qargs, jnp.zeros((1, 1), jnp.int32),
             jnp.zeros((1, 1), jnp.uint32), jnp.zeros((1, 1), jnp.float32)),
        statics)
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    DP = 8 * pw.P_PAGE
    np.testing.assert_array_equal(out[:, :4], ref[:, :4])
    assert (out[:, 1] == 0).any()
    sc = out[:, 4: 4 + DP].view(np.float32)
    rsc = ref[:, 4: 4 + DP].view(np.float32)
    np.testing.assert_array_equal(np.isneginf(sc), np.isneginf(rsc))
    fin = np.isfinite(sc)
    assert fin.any()
    np.testing.assert_allclose(sc[fin], rsc[fin], rtol=3e-7)
    np.testing.assert_array_equal(out[:, 4 + DP: 4 + 2 * DP][fin],
                                  ref[:, 4 + DP: 4 + 2 * DP][fin])
    np.testing.assert_array_equal(out[:, 4 + 2 * DP:], ref[:, 4 + 2 * DP:])


def test_positions_on_one_device_keep_separate_states(tmp_path, route):
    """Two positions on one device hold their own shards' arrays and their
    own WAND parts, and serve the pages of one device."""
    docs = make_docs(np.random.default_rng(28), 300)
    plain = _make(pt, tmp_path / "a", docs, 4)
    idx = _make(pt, tmp_path / "b", docs, 4)
    idx.attach_mesh(["cpu", "cpu"])
    stacked = pmesh.get_stacked(idx, "cpu")
    a, b = stacked.positions
    assert a is not b and a.device == b.device
    assert (a.shard_ids, b.shard_ids) == ([0, 1], [2, 3])
    assert a.docid.data_ptr() != b.docid.data_ptr()
    keys = [k for k in idx._torch_dense_states if isinstance(k, tuple)]
    assert sorted(k[1:] for k in keys) == [(0, "cpu"), (1, "cpu")]
    ws = pw.get_state(idx, "cpu")
    assert ws.parts[0].ppool is not ws.parts[1].ppool
    assert (ws.parts[0].b0, ws.parts[1].b0) == (0, ws.nblk_local)
    reqs = _requests(QUERIES)
    for name in ("wand", "dense"):
        route(name)
        assert [_Page(r) for r in _port(idx, reqs)] == \
            [_Page(r) for r in _port(plain, reqs)]
    assert all(n > 0 for n in ws.n_prows)


def test_cuda_mesh_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.make_mesh(["cuda:0"] * 4)
    # an index bound to CUDA whose host shows no card: attach_mesh() with
    # no mesh raises as resolve_device does
    idx = _make(pt, tmp_path, make_docs(np.random.default_rng(3), 20), 2)
    idx.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        idx.attach_mesh()
    assert getattr(idx, "_mesh", None) is None
