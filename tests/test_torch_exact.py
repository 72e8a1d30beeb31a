"""The WAND route's exact evaluations in the torch port against the JAX
reference on the CPU: the device exact scan for stragglers
(seekstorm_tpu_torch/ops/wand.py::wand_exact_scan) and the host exact
evaluation, under the reference's three switches.

tests/test_wand.py's corpus (BLOCK_SIZE + 6,000 docs, two blocks), built by
each package on one shard and on two.  The queries and query types are
those of tests/test_wand_pallas.py::test_dev_exact_matches_dense and
tests/test_wand.py::test_exact_fallback_matches_dense, as TopkCount pages.

  * SEEKSTORM_TPU_WAND_FORCE_FALLBACK: every query to the host exact
    evaluation; pages and counts equal the reference's bit for bit;
  * SEEKSTORM_TPU_WAND_FORCE_DEV_EXACT (one shard): every query to the
    device exact scan; pages and counts equal the host exact evaluation of
    both packages bit for bit, and the reference's device scan in ids,
    order and counts.  Its scores differ from that scan's by at most one
    ulp: XLA on the CPU contracts the reference's rescore chain into fused
    multiply-adds, so its device scan is not bitwise its own host
    evaluation, which rounds twice a term as the port's scan does;
  * SEEKSTORM_TPU_WAND_DEV_EXACT: the opt-in takes the real stragglers of a
    batch on one shard (wand_dev_exact_total counts them) and gives the
    host evaluation's pages; with two shards it stays off, as
    SEEKSTORM_TPU_WAND_FORCE_DEV_EXACT does.
"""

import numpy as np
import pytest

import seekstorm_tpu as st
import seekstorm_tpu_torch as pt
from seekstorm_tpu.schema import BLOCK_SIZE
from test_torch_search import _Pair, _create, _to_port
from test_wand import _Page, _queries

PALLAS_QUERIES = ["w001 w002", "w003", "+w004 w005", "-w006 w007 w008",
                  "w010 w011 w012 w013", "w000 w001"]
FALLBACK_QUERIES = _queries(16, seed=3)


@pytest.fixture(scope="module", params=[1, 2], ids=["s1", "s2"])
def index(request, tmp_path_factory):
    rng = np.random.default_rng(7)
    vocab = [f"w{i:03d}" for i in range(250)]
    docs = [{"title": " ".join(rng.choice(vocab, 3)),
             "body": " ".join(rng.choice(vocab, 18))}
            for _ in range(BLOCK_SIZE + 6_000)]
    path = tmp_path_factory.mktemp("tx")
    out = []
    for pkg in (st, pt):
        schema = [
            pkg.SchemaField("title", pkg.FieldType.Text, indexed=True,
                            boost=10.0),
            pkg.SchemaField("body", pkg.FieldType.Text, indexed=True),
        ]
        idx = _create(pkg, path, schema, shard_count=request.param)
        idx.index_documents(docs)
        idx.commit()
        out.append(idx)
    return _Pair(*out)


def _reqs(queries, qtype):
    return [st.SearchRequest(query=q, length=10,
                             result_type=st.ResultType.TopkCount,
                             realtime=False, query_type_default=qtype)
            for q in queries]


def _bits(rs):
    return (rs.result_count_total,
            [(r.doc_id, np.float32(r.score).view(np.int32).item())
             for r in rs.results])


def _run(idx, reqs, monkeypatch, port: bool, **env):
    """Result sets of one package under SEEKSTORM_TPU_WAND=1 and env, and
    the change of the port's metrics."""
    env = {"SEEKSTORM_TPU_WAND": "1", **env}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    before = pt.METRICS.snapshot()
    try:
        if port:
            out = pt.search_batch(idx.port, _to_port(reqs), device="cpu")
        else:
            out = st.search_batch(idx.ref, reqs)
    finally:
        for k in env:
            monkeypatch.delenv(k)
    after = pt.METRICS.snapshot()
    return out, {k: after.get(k, 0.0) - before.get(k, 0.0)
                 for k in ("wand_dev_exact_total", "wand_fallbacks_total",
                           "wand_exact_fallback_count")}


QUERY_SETS = [
    ("pallas", PALLAS_QUERIES, st.QueryType.Union),
    ("pallas", PALLAS_QUERIES[:4], st.QueryType.Intersection),
    ("fallback", FALLBACK_QUERIES, st.QueryType.Union),
    ("fallback", FALLBACK_QUERIES, st.QueryType.Intersection),
]


@pytest.mark.parametrize("case", range(len(QUERY_SETS)),
                         ids=[f"{n}-{q.value}" for n, _, q in QUERY_SETS])
def test_force_fallback_matches_reference(index, case, monkeypatch):
    _, queries, qtype = QUERY_SETS[case]
    reqs = _reqs(queries, qtype)
    env = dict(SEEKSTORM_TPU_WAND_FORCE_FALLBACK="1")
    mine, moved = _run(index, reqs, monkeypatch, True, **env)
    ref, _ = _run(index, reqs, monkeypatch, False, **env)
    assert [_bits(rs) for rs in mine] == [_bits(rs) for rs in ref]
    assert moved["wand_exact_fallback_count"] == len(reqs)
    assert moved["wand_dev_exact_total"] == 0
    assert sum(rs.result_count_total > 0 for rs in mine) > len(reqs) // 2


@pytest.mark.parametrize("case", range(len(QUERY_SETS)),
                         ids=[f"{n}-{q.value}" for n, _, q in QUERY_SETS])
def test_force_dev_exact_matches_reference(index, case, monkeypatch):
    _, queries, qtype = QUERY_SETS[case]
    reqs = _reqs(queries, qtype)
    env = dict(SEEKSTORM_TPU_WAND_FORCE_DEV_EXACT="1")
    mine, moved = _run(index, reqs, monkeypatch, True, **env)
    ref_dx, _ = _run(index, reqs, monkeypatch, False, **env)
    ref_fb, _ = _run(index, reqs, monkeypatch, False,
                     SEEKSTORM_TPU_WAND_FORCE_FALLBACK="1")
    # pages and counts: bitwise the host exact evaluation's
    assert [_bits(rs) for rs in mine] == [_bits(rs) for rs in ref_fb]
    if index.shard_count > 1:
        # several shards keep the host path, in both packages
        assert moved["wand_dev_exact_total"] == 0
        assert [_bits(rs) for rs in mine] == [_bits(rs) for rs in ref_dx]
        return
    # groups of 4 queries, the last of 1, 2 or 4 (3 padded to 4)
    assert moved["wand_dev_exact_total"] == -(-len(reqs) // 4)
    for a, b in zip(mine, ref_dx):
        assert a.result_count_total == b.result_count_total
        assert [r.doc_id for r in a.results] == [r.doc_id for r in b.results]
        sa = np.array([r.score for r in a.results], np.float32)
        sb = np.array([r.score for r in b.results], np.float32)
        assert (np.abs(sa - sb) <= np.spacing(np.maximum(sa, sb))).all()


def test_dev_exact_takes_real_stragglers(index, monkeypatch):
    """SEEKSTORM_TPU_WAND_DEV_EXACT=1: a batch's UB-saturated queries take
    the device exact scan on one shard, with the pages the host exact
    evaluation gives them without it; with two shards the switch does
    nothing."""
    reqs = _reqs(_queries(), st.QueryType.Union)
    host, moved0 = _run(index, reqs, monkeypatch, True)
    assert moved0["wand_fallbacks_total"] > 0, "no straggler in the batch"
    assert moved0["wand_dev_exact_total"] == 0
    dev, moved = _run(index, reqs, monkeypatch, True,
                      SEEKSTORM_TPU_WAND_DEV_EXACT="1")
    assert moved["wand_fallbacks_total"] == moved0["wand_fallbacks_total"]
    if index.shard_count == 1:
        assert moved["wand_dev_exact_total"] >= 1
        assert moved["wand_exact_fallback_count"] == 0
    else:
        assert moved["wand_dev_exact_total"] == 0
    assert [_bits(rs) for rs in dev] == [_bits(rs) for rs in host]
    ref, _ = _run(index, reqs, monkeypatch, False,
                  SEEKSTORM_TPU_WAND_DEV_EXACT="1")
    assert [_Page(rs) for rs in dev] == [_Page(rs) for rs in ref]
