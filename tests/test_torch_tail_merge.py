"""The realtime tail merge in posting space (``seekstorm_tpu_torch/tail.py``
through ``search._merge_tail``) against its plain version.

The plain version is the per-query loop the merge replaced: the tail's
postings gathered slot by slot from level 0, ``oracle.score_query`` over
the dense tail and ``oracle.topk_from_scores`` for each query.  A batch is
searched twice, once with each merge, and what the merges hand to
``_finalize_lexical`` must be the same: every query's candidate scores and
ids bit for bit and in order, the counts, the facet counts and the tail's
phrase counts.

Besides: a realtime batch reads each distinct term hash of its slots from
a shard's level 0 once (the native accumulator and the pure-Python level
0); the idf's tail df equals the per-slot count it replaced on a quiet
tail; and under a concurrent ingest the idf and the merge of each batch
read the same docs.
"""

import copy
import importlib
import sys
import threading
from collections import Counter

import numpy as np
import pytest

import seekstorm_tpu_torch as pt
from seekstorm_tpu_torch import geo as geo_mod
from seekstorm_tpu_torch.index import NativeLevel0
from seekstorm_tpu_torch.native import NativeAccumulator
from seekstorm_tpu_torch.oracle import (OracleTermPostings, bm25_components,
                                        score_query, term_impacts,
                                        topk_from_scores)
from seekstorm_tpu_torch.schema import FieldType
from seekstorm_tpu_torch.utils import term_hash

ps = importlib.import_module("seekstorm_tpu_torch.search")
tail_mod = importlib.import_module("seekstorm_tpu_torch.tail")

BRANDS = ["acme", "globex", "initech", "umbrella"]
STOP = ["the", "of", "and", "to", "in"]


# ---------------------------------------------------------------------------
# the plain merge


def _plain_postings(index, shard, slots, boosts):
    """Each slot's tail postings (ids relative to the tail's start) and its
    tail df, gathered slot by slot from level 0."""
    l0 = shard.level0
    start = shard.partial_on_disk
    n_tail = l0.doc_count - start
    end = start + n_tail
    F = shard.n_fields
    avg = index._avg_len(shard)

    def lookup(h):
        if isinstance(l0, NativeLevel0):
            hit = l0.acc.term_postings(h)
            if hit is None:
                return None
            return hit[0].astype(np.int64), hit[1]
        tp = l0.terms.get(h)
        if tp is None:
            return None
        return (np.asarray(tp.docids, dtype=np.int64),
                np.asarray(tp.tfs, dtype=np.uint16).reshape(-1, F))

    out, dfs = [], []
    for sl in slots:
        h = term_hash(sl.term) if sl.tf_hash is not None else sl.hash
        hit = lookup(h)
        if hit is None:
            out.append(None)
            dfs.append(0)
            continue
        docids, tf = hit
        chit = lookup(sl.tf_hash) if sl.tf_hash is not None else None
        if chit is not None:
            cd, ctf = chit
            pos = np.minimum(np.searchsorted(cd, docids), len(cd) - 1)
            found = cd[pos] == docids
            tf = np.where(found[:, None], ctf[pos], tf)
            dfs.append(int(np.sum((cd >= start) & (cd < end))))
        else:
            dfs.append(int(np.sum((docids >= start) & (docids < end))))
        sel = (docids >= start) & (docids < end)
        if not sel.any():
            out.append(None)
            continue
        dl = np.frombuffer(b"".join(l0.doclen[i] for i in docids[sel]),
                           dtype=np.uint8).reshape(-1, F)
        imps = term_impacts(tf[sel], bm25_components(dl, avg), boosts)
        out.append(OracleTermPostings(docids=docids[sel] - start,
                                      impacts=imps, positions=None))
    return out, dfs, n_tail


def _plain_merge(index, tail, slots, specs, boosts, merged_scores,
                 merged_ids, counts, with_counts, req0=None, facet_specs=(),
                 fc_total=None, fcm=1, sorting=False, sort_desc=True,
                 tail_phrase_counts=None):
    shard = tail.shard
    postings, tail_dfs, n_tail = _plain_postings(index, shard, slots, boosts)
    lex = shard.lexical
    d = lex.directory
    base = shard.tail_start
    start = shard.partial_on_disk
    tail_deleted = np.zeros(n_tail, dtype=bool)
    for sid in shard.deleted:
        if base <= sid < base + n_tail:
            tail_deleted[sid - base] = True

    def tail_col(field):
        sf = index.schema_map[field]
        vv = shard.level0.facet_values.get(sf.facet_id, [])[
            start:start + n_tail]
        if sf.field_type == FieldType.Point:
            return geo_mod.encode_morton_2_d(
                np.array([v[0] if v else 0.0 for v in vv]),
                np.array([v[1] if v else 0.0 for v in vv]))
        return np.array([0 if v is None else v for v in vv], np.float64)

    for f in (req0.facet_filter if req0 is not None else ()):
        sf = index.schema_map[f.field]
        col = tail_col(f.field)
        if f.values is not None:
            if sf.field_type.is_string_facet:
                tab = index._facet_tables.get(sf.facet_id, {"": 0})
                vals = [tab.get(str(v), -1) for v in f.values]
            else:
                vals = [float(v) for v in f.values]
            tail_deleted |= ~np.isin(col, vals)
        else:
            lo, hi = f.range
            tail_deleted |= ~((col >= lo) & (col <= hi))
    tail_key = None
    if sorting and req0 is not None and req0.result_sort:
        rs0 = req0.result_sort[0]
        col = tail_col(rs0.field)
        if index.schema_map[rs0.field].field_type == FieldType.Point:
            tail_key = geo_mod.point_distance(
                col, float(rs0.base[0]), float(rs0.base[1])
            ).astype(np.float32)
        else:
            tail_key = col.astype(np.float32)

    n_docs = lex.doc_count + n_tail
    for qi, spec in enumerate(specs):
        term_ps, dfs, reqs, negs = [], [], [], []
        for s in spec.slots:
            sl = slots[s]
            ti = d.lookup(sl.idf_hash if sl.idf_hash is not None else sl.hash)
            term_ps.append(postings[s])
            dfs.append((int(d.df[ti]) if ti >= 0 else 0) + tail_dfs[s])
            reqs.append(bool(spec.required.get(s))
                        and not spec.negated.get(s))
            negs.append(bool(spec.negated.get(s)))
        sc, matched = score_query(n_docs, n_tail, term_ps, dfs, reqs, negs,
                                  tail_deleted)
        if with_counts:
            if spec.phrases and tail_phrase_counts is not None:
                for li in np.flatnonzero(matched):
                    g = ((int(li) + base) * index.shard_count
                         + shard.shard_id)
                    if ps._phrase_ok(index, slots, spec, g):
                        tail_phrase_counts[qi] += 1
            else:
                counts[qi] += int(matched.sum())
        for fi, (qf, _labels, _nc) in enumerate(facet_specs or ()):
            sf = index.schema_map[qf.field]
            col = tail_col(qf.field)
            if qf.ranges is not None:
                if sf.field_type == FieldType.Point:
                    col = geo_mod.point_distance(
                        col, float(qf.ranges.base[0]),
                        float(qf.ranges.base[1]))
                bounds = np.array([float(r[1]) for r in qf.ranges.ranges])
                codes = np.searchsorted(bounds, col, side="right")
            else:
                codes = col.astype(np.int64)
            codes = np.clip(codes, 0, fcm - 1)
            np.add.at(fc_total[fi, qi], codes[matched], 1)
        if sorting and tail_key is not None:
            rank = np.where(matched, tail_key if sort_desc else -tail_key,
                            np.float32(-np.inf)).astype(np.float32)
            s2, ids = topk_from_scores(rank, min(n_tail, 1024))
        else:
            s2, ids = topk_from_scores(sc, min(n_tail, 1024))
        gids = (ids + base) * index.shard_count + shard.shard_id
        merged_scores[qi] = np.concatenate([merged_scores[qi], s2])
        merged_ids[qi] = np.concatenate([merged_ids[qi], gids])


# ---------------------------------------------------------------------------
# indexes and batches


def _docs(rng, n, words, stop=False):
    vocab = np.array(words)
    out = []
    for _ in range(n):
        body = list(vocab[rng.integers(0, len(vocab), 12)])
        if stop:
            for j in rng.choice(12, 4, replace=False):
                body[j] = STOP[int(rng.integers(0, len(STOP)))]
        out.append({
            "title": " ".join(vocab[rng.integers(0, len(vocab), 3)]),
            "body": " ".join(body),
            "brand": BRANDS[int(rng.integers(0, len(BRANDS)))],
            "price": int(rng.integers(1, 500)),
            "loc": [float(rng.uniform(40, 60)), float(rng.uniform(-10, 10))],
        })
    return out


def _make_index(path, shards, n_committed, n_tail, seed, ngram=False,
                deletes=False):
    schema = [
        pt.SchemaField("title", pt.FieldType.Text, stored=True, indexed=True,
                       boost=10.0),
        pt.SchemaField("body", pt.FieldType.Text, stored=True, indexed=True),
        pt.SchemaField("brand", pt.FieldType.String16, stored=True,
                       facet=True),
        pt.SchemaField("price", pt.FieldType.U16, stored=True, facet=True),
        pt.SchemaField("loc", pt.FieldType.Point, stored=True, facet=True),
    ]
    meta = (pt.IndexMeta(ngram_indexing=1 | 2 | 4 | 8,
                         frequent_words=pt.FrequentwordType.English)
            if ngram else None)
    idx = pt.create_index(path, schema, meta=meta, shard_count=shards,
                          device="cpu")
    rng = np.random.default_rng(seed)
    words = [f"w{i:03d}" for i in range(60)]
    committed = idx.index_documents(_docs(rng, n_committed, words, ngram))
    idx.commit()
    tail = idx.index_documents(_docs(rng, n_tail, words, ngram))
    if deletes:
        idx.delete_documents([int(g) for g in rng.choice(committed, 40)]
                             + [int(g) for g in rng.choice(tail, 60)])
    return idx


def _queries(rng, n, ngram=False):
    w = lambda: f"w{int(rng.integers(0, 60)):03d}"   # noqa: E731
    out = []
    for i in range(n):
        kind = i % 8
        if ngram:
            s = STOP[int(rng.integers(0, len(STOP)))]
            out.append((f'"{s} {w()}"' if kind % 2 else f'"{w()} {s}"',
                        "Union"))
        elif kind == 0:
            out.append((w(), "Union"))
        elif kind in (1, 2):
            out.append((f"{w()} {w()}", "Union"))
        elif kind == 3:
            out.append((f"{w()} {w()}", "Intersection"))
        elif kind == 4:
            out.append((f"+{w()} {w()} {w()}", "Union"))
        elif kind == 5:
            out.append((f"{w()} {w()} -{w()}", "Union"))
        elif kind == 6:
            out.append((f"{w()} {w()} {w()}", "Intersection"))
        else:
            out.append((f'"{w()} {w()}" {w()}', "Union"))
    return out


CASES = {
    # name: (index args, request args, query args)
    "union_intersection": (dict(shards=1, n_committed=300, n_tail=500,
                                seed=1), {}, {}),
    "topk_only": (dict(shards=1, n_committed=300, n_tail=1500, seed=2),
                  dict(result_type="Topk"), {}),
    "deletes": (dict(shards=1, n_committed=400, n_tail=2000, seed=3,
                     deletes=True), {}, {}),
    "filter_values": (dict(shards=1, n_committed=300, n_tail=1200, seed=4,
                           deletes=True),
                      dict(facet_filter=[pt.FacetFilter(
                          "brand", values=["acme", "initech"])]), {}),
    "filter_range": (dict(shards=1, n_committed=300, n_tail=1200, seed=5),
                     dict(facet_filter=[pt.FacetFilter(
                         "price", range=(50, 300))]), {}),
    "query_facets": (dict(shards=1, n_committed=300, n_tail=1500, seed=6),
                     dict(query_facets=[
                         pt.QueryFacet("brand"),
                         pt.QueryFacet("price", ranges=pt.Ranges(
                             "price", [("cheap", 0), ("mid", 100),
                                       ("lux", 300)]))]), {}),
    "sort_desc": (dict(shards=1, n_committed=300, n_tail=1000, seed=7),
                  dict(result_sort=[pt.ResultSort("price")]), {}),
    "sort_asc": (dict(shards=1, n_committed=300, n_tail=1000, seed=8,
                      deletes=True),
                 dict(result_sort=[pt.ResultSort("price",
                                                 order="Ascending")]), {}),
    "sort_point": (dict(shards=1, n_committed=300, n_tail=1000, seed=9),
                   dict(result_sort=[pt.ResultSort(
                       "loc", order="Ascending", base=(50.0, 0.0))]), {}),
    "ngram": (dict(shards=1, n_committed=300, n_tail=1500, seed=10,
                   ngram=True), {}, dict(ngram=True)),
    "shards3": (dict(shards=3, n_committed=600, n_tail=5000, seed=11,
                     deletes=True), {}, {}),
}


def _requests(n, seed, req_kw, q_kw):
    rng = np.random.default_rng(seed)
    kw = dict(req_kw)
    rt = kw.pop("result_type", "TopkCount")
    return [pt.SearchRequest(query=q, query_type_default=pt.QueryType[t],
                             result_type=pt.ResultType[rt], length=10,
                             realtime=True, **kw)
            for q, t in _queries(rng, n, **q_kw)]


def _finalize_inputs(monkeypatch, index, requests, merge):
    """What _finalize_lexical receives for a batch searched with `merge`
    as the tail merge, copied as it arrives."""
    seen = []
    finalize = ps._finalize_lexical

    def capture(index, requests, results, live, live_specs, slots,
                merged_scores, merged_ids, counts, counts_exact, with_counts,
                facet_specs=(), fc_total=None, *a, **kw):
        seen.append(copy.deepcopy(dict(
            scores=merged_scores, ids=merged_ids, counts=counts,
            fc_total=fc_total, phrase=kw.get("tail_phrase_counts"))))
        return finalize(index, requests, results, live, live_specs, slots,
                        merged_scores, merged_ids, counts, counts_exact,
                        with_counts, facet_specs, fc_total, *a, **kw)

    with monkeypatch.context() as m:
        m.setattr(ps, "_finalize_lexical", capture)
        m.setattr(ps, "_merge_tail", merge)
        pages = pt.search_batch(index, requests, device="cpu")
    assert len(seen) == 1
    return seen[0], pages


@pytest.mark.parametrize("case", list(CASES))
def test_tail_merge_matches_the_per_query_oracle(case, tmp_path, monkeypatch):
    ix_kw, req_kw, q_kw = CASES[case]
    idx = _make_index(tmp_path / "ix", **ix_kw)
    assert all(sh.tail_len() > 0 for sh in idx.shards)
    reqs = _requests(48, ix_kw["seed"], req_kw, q_kw)
    got, pages = _finalize_inputs(monkeypatch, idx, reqs, ps._merge_tail)
    want, want_pages = _finalize_inputs(monkeypatch, idx, reqs, _plain_merge)
    assert len(got["scores"]) == len(want["scores"])
    for qi, (a, b) in enumerate(zip(got["scores"], want["scores"])):
        assert a.dtype == b.dtype and a.view(np.uint32).tolist() == \
            b.view(np.uint32).tolist(), (case, qi)
    for qi, (a, b) in enumerate(zip(got["ids"], want["ids"])):
        assert a.dtype == b.dtype and a.tolist() == b.tolist(), (case, qi)
    assert got["counts"].tolist() == want["counts"].tolist()
    assert got["fc_total"].tolist() == want["fc_total"].tolist()
    assert got["phrase"].tolist() == want["phrase"].tolist()
    assert [(r.result_count_total, [(o.doc_id, o.score) for o in r.results])
            for r in pages] == [
        (r.result_count_total, [(o.doc_id, o.score) for o in r.results])
        for r in want_pages]
    # the merge scored tail docs, and matched some in every case
    assert sum(len(i) for i in got["ids"]) > 0


# ---------------------------------------------------------------------------
# one read a hash a shard, and the idf's tail df


def _slots(idx, reqs):
    return ps._build_specs(idx, [r.query for r in reqs],
                           [r.query_type_default for r in reqs])


def _batch_hashes(slots):
    out = set()
    for sl in slots:
        out.add(term_hash(sl.term) if sl.tf_hash is not None else sl.hash)
        out.add(sl.idf_hash if sl.idf_hash is not None else sl.hash)
        if sl.tf_hash is not None:
            out.add(sl.tf_hash)
    return out


class _CountingTerms(dict):
    """A pure-Python level 0's postings dict that counts its reads."""

    def __init__(self, d, reads):
        super().__init__(d)
        self.reads = reads

    def get(self, h, default=None):
        self.reads[(id(self), h)] += 1
        return super().get(h, default)


@pytest.mark.parametrize("route", ["wand", "dense"])
@pytest.mark.parametrize("level0", ["native", "python"])
def test_a_batch_reads_each_hash_once_a_shard(level0, route, tmp_path,
                                              monkeypatch):
    if level0 == "python":
        monkeypatch.setenv("SEEKSTORM_TPU_NO_NATIVE", "1")
    if route == "wand":
        monkeypatch.setenv("SEEKSTORM_TPU_WAND", "1")
    else:
        monkeypatch.setenv("SEEKSTORM_TPU_NO_WAND", "1")
    idx = _make_index(tmp_path / "ix", 2, 300, 800, seed=21)
    assert all(isinstance(sh.level0, NativeLevel0) == (level0 == "native")
               for sh in idx.shards)
    # no phrases: their verification reads positions, one doc at a time
    reqs = [r for r in _requests(40, 21, {}, {}) if '"' not in r.query]
    reads = Counter()
    if level0 == "native":
        real = NativeAccumulator.term_postings

        def counted(self, h):
            reads[(id(self), h)] += 1
            return real(self, h)
        monkeypatch.setattr(NativeAccumulator, "term_postings", counted)
    else:
        for sh in idx.shards:
            sh.level0.terms = _CountingTerms(sh.level0.terms, reads)
    pt.search_batch(idx, reqs, device="cpu")
    slots, _ = _slots(idx, reqs)
    want = _batch_hashes(slots)
    per_shard = Counter(owner for owner, _ in reads)
    assert len(per_shard) == len(idx.shards)
    for owner in per_shard:
        got = {h: n for (o, h), n in reads.items() if o == owner}
        assert set(got) == want
        assert max(got.values()) == 1


def test_a_committed_index_reads_no_tail(tmp_path, monkeypatch):
    """A realtime batch over shards with no uncommitted docs makes no
    postings lookup in level 0."""
    idx = _make_index(tmp_path / "ix", 2, 300, 200, seed=22)
    idx.commit()
    assert all(sh.tail_len() == 0 for sh in idx.shards)
    reads = []
    real = NativeAccumulator.term_postings
    monkeypatch.setattr(NativeAccumulator, "term_postings",
                        lambda self, h: reads.append(h) or real(self, h))
    pages = pt.search_batch(idx, _requests(16, 22, {}, {}), device="cpu")
    assert any(r.results for r in pages)
    assert reads == []


def _two_loop_idf(shard, slots):
    """The idf as it was computed before the view: the committed df (the
    slot's own where its idf term is not committed), then one postings
    lookup a slot for the tail df, every posting at or past the tail's
    start."""
    lex = shard.lexical
    d = lex.directory
    l0 = shard.level0
    start = shard.partial_on_disk
    T = len(d.hash)

    def lookup(hs):
        ti = np.minimum(np.searchsorted(d.hash, hs), T - 1)
        return d.hash[ti] == hs, ti

    hs = np.array([sl.hash for sl in slots], np.uint64)
    idf_hs = np.array([sl.idf_hash if sl.idf_hash is not None else sl.hash
                       for sl in slots], np.uint64)
    found, ti = lookup(hs)
    cfound, ci = lookup(idf_hs)
    df_total = np.where(cfound, d.df[ci], np.where(found, d.df[ti], 0))
    n_docs = lex.doc_count + l0.doc_count - start
    for v, h in enumerate(idf_hs.tolist()):
        if isinstance(l0, NativeLevel0):
            hit = l0.acc.term_postings(h)
            if hit is not None:
                df_total[v] += int(np.sum(hit[0] >= start))
        else:
            tp = l0.terms.get(h)
            if tp is not None:
                df_total[v] += int(np.sum(np.asarray(tp.docids) >= start))
    return np.where(df_total > 0, np.log1p(
        (n_docs - df_total + 0.5) / (df_total + 0.5)), 0.0).astype(np.float32)


@pytest.mark.parametrize("ngram", [False, True], ids=["terms", "ngrams"])
@pytest.mark.parametrize("level0", ["native", "python"])
def test_idf_tail_df_equals_the_two_loop_count(level0, ngram, tmp_path,
                                               monkeypatch):
    if level0 == "python":
        monkeypatch.setenv("SEEKSTORM_TPU_NO_NATIVE", "1")
    idx = _make_index(tmp_path / "ix", 2, 300, 700, seed=31, ngram=ngram)
    slots, _ = _slots(idx, _requests(40, 31, {}, dict(ngram=ngram)))
    if ngram:
        assert any(sl.tf_hash is not None for sl in slots)
    for sh in idx.shards:
        want = _two_loop_idf(sh, slots).view(np.uint32).tolist()
        for tails in (None, tail_mod.BatchTails(slots, True)):
            got = ps._shard_idf(sh, slots, True, tails=tails)
            assert got.view(np.uint32).tolist() == want


# ---------------------------------------------------------------------------
# a batch's idf and merge under a concurrent ingest


def test_idf_and_merge_read_one_snapshot_under_ingest(tmp_path, monkeypatch):
    """One thread ingests while another runs realtime batches: every batch
    finishes, and in every batch the idf's tail df and the merge's scored
    docs come from the same [start, end) (the old idf counted postings past
    the merge's end)."""
    idx = _make_index(tmp_path / "ix", 2, 300, 200, seed=41)
    batches: list[dict] = []
    init, idf_df = tail_mod.BatchTails.__init__, tail_mod.TailView.idf_df
    merge = ps._merge_tail

    def new_batch(self, slots, realtime):
        batches.append({"idf": [], "merge": []})
        init(self, slots, realtime)

    def record_idf(self, slots):
        out = idf_df(self, slots)
        batches[-1]["idf"].append((self, [
            sl.idf_hash if sl.idf_hash is not None else sl.hash
            for sl in slots], out))
        return out

    def record_merge(index, tail, slots, specs, boosts, merged_scores,
                     merged_ids, *a, **kw):
        before = [len(m) for m in merged_ids]
        merge(index, tail, slots, specs, boosts, merged_scores, merged_ids,
              *a, **kw)
        new = np.concatenate([m[n:] for m, n in zip(merged_ids, before)])
        batches[-1]["merge"].append((tail, new // index.shard_count))

    monkeypatch.setattr(tail_mod.BatchTails, "__init__", new_batch)
    monkeypatch.setattr(tail_mod.TailView, "idf_df", record_idf)
    monkeypatch.setattr(ps, "_merge_tail", record_merge)

    rng = np.random.default_rng(41)
    words = [f"w{i:03d}" for i in range(60)]
    reqs = _requests(32, 41, {}, {})
    done = threading.Event()
    errors: list = []
    n_batches = [0]

    def ingest():
        try:
            for _ in range(40):
                idx.index_documents(_docs(rng, 25, words))
        except Exception as e:   # reported below
            errors.append(e)
        finally:
            done.set()

    def search():
        try:
            while not done.is_set() or n_batches[0] < 3:
                pages = pt.search_batch(idx, reqs, device="cpu")
                assert len(pages) == len(reqs)
                n_batches[0] += 1
        except Exception as e:   # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=ingest),
                   threading.Thread(target=search)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert n_batches[0] >= 3 and len(batches) == n_batches[0]

    # level 0 only grows: the postings in a view's [start, end) are the
    # same now as when its batch read them
    for b in batches:
        views = {id(v) for v, _, _ in b["idf"]}
        for v, hashes, dfs in b["idf"]:
            l0 = v.shard.level0
            for h, df in zip(hashes, dfs.tolist()):
                hit = l0.acc.term_postings(h)
                ids = np.zeros(0) if hit is None else hit[0]
                assert df == int(np.sum((ids >= v.start) & (ids < v.end)))
        for v, local in b["merge"]:
            assert id(v) in views
            assert ((local >= v.base) & (local < v.base + v.n_tail)).all()
