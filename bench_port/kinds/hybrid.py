"""The ``hybrid`` kind of deployment: title and body fields, BM25F, and the
body's chunks embedded by the index's own Model2Vec model, searched in
``SearchMode.Hybrid``: the lexical and the vector list fused by RRF.

Its committed index is the configuration's generated corpus, with a
Model2Vec model (an embedding table from the configuration's
``model_seed`` and a vocabulary of the generator's words) written beside
it; each run ingests a tail of generated documents (their chunks embedded
at ingest), sends the cell's keyword queries with no query vector, so that
the program embeds them, and judges what the window served against
``reference/hybrid.py``.  It imports nothing of the other kinds: the index
cache's key hashes this file alone of ``kinds/``.
"""

from __future__ import annotations

import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

from gen import corpus, traffic
from harness.recorder import Recorder, limits_check
from harness.requests import search_requests
from reference import bm25f, hybrid

KIND = "hybrid"
# (configuration sizes, cell sizes) of the CPU tests
TINY = ({"n_docs": 6_000}, {"pool": 96, "batch": 32, "tail": 200})
# the lexical page's relative tie band: the text cells' page_gap limit
TIE = 1e-4
# a served doc carries a vector term only if it is among the exact top NEAR
# docs by best chunk: the program's list is the top over the probed rows
# at i8, which can hold docs the exact list ranks below its own 20th; about
# twice the deepest such doc of the sound runs (PERF.md section 2)
NEAR = 640
# two sums of RRF terms this close (relative) are one reading of a score
MATCH = 1e-12

def pool(cell: dict, config: dict, seed: int) -> list[tuple[str, str]]:
    """The cell's query pool: (query, type) pairs drawn by its ``mix``."""
    return traffic.text_queries(int(cell["pool"]),
                                traffic.pool_rng(cell, seed), cell["mix"])


def tail(cell: dict, config: dict, seed: int):
    """The uncommitted tail every run ingests anew: corpus.corpus_tokens
    arrays."""
    return corpus.corpus_tokens(int(cell["tail"]), int(config["vocab"]),
                                traffic.rng_for(seed, traffic.TAIL))


def model_table(config: dict) -> np.ndarray:
    """The Model2Vec embedding table f32 [vocab, dim], from the
    configuration's ``model_seed``."""
    v = config["vector"]
    return np.random.default_rng(int(v["model_seed"])).standard_normal(
        (int(config["vocab"]), int(v["dim"]))).astype(np.float32)


def vocabulary(config: dict) -> dict:
    """The model's words: the generator's, ``w`` and five digits."""
    return {f"w{i:05d}": i for i in range(int(config["vocab"]))}


def bodies(title_len, body_len, stream):
    """(body_len, each body's first word in `stream`) of corpus_tokens
    arrays."""
    doc_start = np.cumsum(title_len + body_len) - (title_len + body_len)
    return np.asarray(body_len, np.int64), doc_start + title_len


class System:
    def __init__(self, config: dict, cell: dict, seed: int):
        self.config, self.cell, self.seed = config, cell, seed
        self.vocab = int(config["vocab"])

    # -- the cached committed index --------------------------------------
    def build(self, st, where: Path, device: str) -> None:
        c = self.config
        t0 = time.perf_counter()
        arrays = corpus.corpus_tokens(int(c["n_docs"]), self.vocab,
                                      np.random.default_rng(c["data_seed"]))
        bm25f.postings(*arrays, self.vocab).save(where / "committed.npz")
        body_len, body_at = bodies(*arrays)
        np.savez(where / "bodies.npz", body_len=body_len, body_at=body_at,
                 stream=arrays[2])
        model = where / "model"
        model.mkdir()
        np.save(model / "embeddings.npy", model_table(c))
        (model / "vocab.json").write_text(json.dumps(vocabulary(c)))
        schema = [st.SchemaField(
            f["name"], st.FieldType.Text, indexed=True,
            boost=float(f["boost"]),
            index_vector=f["name"] == c["vector"]["field"])
            for f in c["fields"]]
        idx = st.create_index(where / "index", schema, meta=self._meta(st,
                                                                     model),
                              shard_count=int(c["shards"]), device=device)
        docs = corpus.docs_from_tokens(*arrays)
        del arrays
        t1 = time.perf_counter()
        step = int(c.get("ingest_step", 1 << 16))
        for a in range(0, len(docs), step):
            idx.index_documents(docs[a:a + step])
        idx.commit()
        del idx
        t2 = time.perf_counter()
        m = st.METRICS.snapshot()
        print(f"[build] data and references {t1 - t0:.1f} s, ingest and "
              f"commit {t2 - t1:.1f} s, of which the vectors' ingest "
              f"(chunks, Model2Vec) "
              f"{m.get('vector_ingest_seconds_total', 0.0):.1f} s and their "
              f"levels' commit (clustering, quantization, files) "
              f"{m.get('vector_pack_seconds_total', 0.0):.1f} s",
              file=sys.stderr, flush=True)

    def _meta(self, st, model: Path):
        v = self.config["vector"]
        return st.IndexMeta(vector=st.VectorConfig(
            enabled=True, dim=int(v["dim"]),
            similarity=st.VectorSimilarity[v["similarity"]],
            precision=st.Precision[v["precision"]],
            quantization=st.Quantization[v["quantization"]],
            inference=st.InferenceType[v["inference"]], model=str(model),
            chunk_size=int(v["chunk_size"]),
            clustering=st.ClusteringConfig(
                mode=st.ClusteringMode[v["clustering"]])))

    def open(self, st, where: Path, device: str):
        self.committed = bm25f.Postings.load(where / "committed.npz")
        with np.load(where / "bodies.npz") as z:
            self.bodies = (z["body_len"], z["body_at"], z["stream"])
        return st.open_index(where / "index", device=device)

    def ingest_tail(self, idx) -> int:
        self.tail_arrays = tail(self.cell, self.config, self.seed)
        docs = corpus.docs_from_tokens(*self.tail_arrays)
        idx.index_documents(docs)
        return len(docs)

    def requests(self, st) -> list:
        self.pool = pool(self.cell, self.config, self.seed)
        self.reqs = search_requests(st, self.cell, [
            dict(query=q, query_type_default=t) for q, t in self.pool])
        return self.reqs

    def readings(self, idx, device: str) -> dict:
        """The uploaded vector index's clusters and rows, which
        ``kernels.roofline_pct.hyb`` reads beside the served work."""
        import torch

        dev = idx.vectors.device(idx.shards[0], torch.device(device))
        return dict(vec_clusters=int(dev["n_clusters"]),
                    vec_rows=int(dev["n_rows"]),
                    dim=int(self.config["vector"]["dim"]))

    # -- what the window served ------------------------------------------
    def recorder(self) -> Recorder:
        return Recorder(traffic.check_sample(self.cell, self.seed),
                        keep_all=True)

    def work(self, served: np.ndarray) -> dict:
        """The lexical list's work (every posting of the served queries'
        distinct terms, committed plus the tail's where the request is
        realtime, and its entries written) and the queries served."""
        df_c = np.diff(self.committed.term_off).astype(np.int64)
        df_t = np.diff(self.tail_postings().term_off).astype(np.int64)
        per_query = np.array([
            sum(int(df_c[t]) + (int(df_t[t]) if r.realtime else 0)
                for t in {int(w[1:]) for w in q.split()})
            for (q, _), r in zip(self.pool, self.reqs)], np.int64)
        need = np.array([_need(r) for r in self.reqs], np.int64)
        n = served.astype(np.int64)
        return {"lex_postings": int((per_query * n).sum()),
                "lex_page_entries": int((need * n).sum()),
                "queries": int(n.sum())}

    def tail_postings(self) -> bm25f.Postings:
        if getattr(self, "_tail_p", None) is None:
            self._tail_p = bm25f.postings(*self.tail_arrays, self.vocab)
        return self._tail_p

    # -- the check --------------------------------------------------------
    def lexical(self, precision: str = "f32",
                realtime: bool = True) -> bm25f.BM25F:
        """The plain BM25F over the committed documents, plus the tail's
        where `realtime`."""
        boosts = [float(f["boost"]) for f in self.config["fields"]]
        tail_p = self.tail_postings() if realtime else bm25f.Postings(
            term_off=np.zeros(self.vocab + 1, np.int64),
            doc=np.zeros(0, np.int32), tf=np.zeros((0, 2), np.uint16),
            codes=np.zeros((0, 2), np.uint8))
        return bm25f.BM25F(self.committed, tail_p, boosts, precision)

    def vectors(self, device: str, precision: str = "exact",
                realtime: bool = True) -> hybrid.VectorLists:
        """Every chunk row of the committed bodies and, where `realtime`,
        of the tail's, embedded by the plain Model2Vec (once a run)."""
        if getattr(self, "_rows", None) is None:
            table = model_table(self.config)
            size = int(self.config["vector"]["chunk_size"])

            def rows(body_len, body_at, stream, first_doc):
                doc, first, n = hybrid.chunk_spans(body_len, size)
                x = hybrid.embed_spans(stream, body_at[doc] + first, n,
                                       table, device)
                return x, doc + first_doc

            self._rows = (rows(*self.bodies, 0),
                          rows(*bodies(*self.tail_arrays),
                               self.tail_arrays[2], self.committed.n_docs))
        (c, c_doc), (t, t_doc) = self._rows
        if not realtime:
            t, t_doc = t[:0], t_doc[:0]
        return hybrid.VectorLists(c, c_doc, t, t_doc, precision)

    def query_vectors(self, entries) -> np.ndarray:
        vocab = vocabulary(self.config)
        return hybrid.embed_ids(
            [hybrid.tokens(self.pool[pi][0], vocab) for pi in entries],
            model_table(self.config))

    def judge(self, rec: Recorder, device: str,
              control: bool = False) -> tuple[dict, dict]:
        """fuse_err over the sampled entries: for each served (doc,
        score), the least |score - l - v| / score, l the lexical term of a
        rank the doc's reference BM25F score can hold (within TIE of the
        reference's score at that rank) or 0 where the doc can lie below
        the lexical list, v 0 or, where the doc is among the exact top NEAR
        docs by best chunk, the vector term of any rank; infinite for a
        page out of (score desc, doc asc) order or with an id twice.
        vec_order over the sampled entries: the vector ranks the page's
        scores imply (a doc's one reading of l + v) held to the reference's
        i8 scores of each doc's chunk rows, best and worst (the program
        scores a doc by its best probed row, which lies between them): the
        most by which a doc's worst row beats the best row of a doc ranked
        above it, or beats the r-th best other doc where it claims rank r;
        infinite for two docs of a page on one rank.  miss_share, one less
        recall@10 against the exact fused top-10, ties counted, over every
        served query; short_pages.  With `control`, the reference at the
        precision below the configuration's (bf16 BM25F, 4-bit vector
        rows) is judged in the program's place, and the reference with
        4-bit vector rows alone is logged beside it."""
        entries = sorted(rec.all_answers)
        reqs = {pi: self.reqs[pi] for pi in entries}
        realtime = {r.realtime for r in reqs.values()}
        if len(realtime) != 1:
            raise ValueError("one realtime setting a cell")
        realtime = realtime.pop()
        need = {pi: _need(r) for pi, r in reqs.items()}
        top = max(need.values(), default=20)
        sample = set(rec.sample.tolist())
        sampled = [i for i, pi in enumerate(entries) if pi in sample]
        q = self.query_vectors(entries)
        exact = self.vectors(device, "exact", realtime)
        lists = {pi: ids for pi, (ids, _) in zip(entries,
                                                  exact.top(q, top, device))}
        near = {entries[i]: {int(d): r for r, d in enumerate(ids)}
                for i, (ids, _) in zip(sampled, exact.top(q[sampled], NEAR,
                                                          device))}
        del exact
        i8 = self.vectors(device, "i8", realtime)
        ranked = {entries[i]: ids_s for i, ids_s in zip(
            sampled, i8.top(q[sampled], top + 1, device))}
        qi = {pi: q[i] for i, pi in enumerate(entries)}
        lex = self.lexical("f32", realtime)
        sets = {"program": rec.all_answers}
        if control:
            low_v = self.vectors(device, "4bit", realtime).top(q, top,
                                                                device)
            low_v = {pi: ids for pi, (ids, _) in zip(entries, low_v)}
            low_l = self.lexical("bf16", realtime)
            sets = {"control": {}, "4-bit vectors alone": {}}
        tally = {name: _Tally() for name in sets}
        for pi in entries:
            k = reqs[pi].length
            want_ids, want, sc = hybrid.lexical_page(lex, *self.pool[pi],
                                                     need[pi])
            if control:
                times = sum(rec.all_answers[pi].values())
                low_ids = hybrid.lexical_page(low_l, *self.pool[pi],
                                              need[pi])[0]
                for name, lex_ids in (("control", low_ids),
                                      ("4-bit vectors alone", want_ids)):
                    ids, scores = hybrid.fuse(lex_ids, low_v[pi][:need[pi]],
                                              k)
                    sets[name][pi] = Counter({(tuple(ids), tuple(scores),
                                               0): times})
            vec_ids = lists[pi][:need[pi]]
            _, truth = hybrid.fuse(want_ids, vec_ids, k)
            thr = truth[-1] if len(truth) == k else 0.0
            v_term = {int(d): 1.0 / (hybrid.RRF_K + i)
                      for i, d in enumerate(vec_ids)}
            for name, answers in sets.items():
                t = tally[name]
                for (ids, scores, _), times in answers[pi].items():
                    t.n_q += times
                    t.short += times * (len(ids) != k)
                    best = [max(_lex_terms(d, sc, want, need[pi]))
                            + v_term.get(d, 0.0) for d in ids]
                    t.found += times * min(sum(b >= thr for b in best),
                                           k) / k
                    if pi in sample:
                        t.checked += times
                        e, order, deep = _page(
                            ids, scores, sc, want, need[pi], near[pi],
                            lambda docs: i8.doc_scores(qi[pi], docs),
                            ranked[pi])
                        t.err = max(t.err, e)
                        t.order = max(t.order, order)
                        t.deepest = max(t.deepest, deep)
        out = {name: t.numbers() for name, t in tally.items()}
        for name, t in tally.items():
            print(f"[check] {name}: the deepest exact vector rank of a "
                  f"sampled doc that needs a vector term: {t.deepest} "
                  f"(NEAR {NEAR})" + (f"; numbers {json.dumps(out[name])}"
                                     if name != "program" else ""),
                  file=sys.stderr, flush=True)
        self.numbers = out
        numbers = out["control" if control else "program"]
        self.recall = 1.0 - numbers["miss_share"]
        return numbers, limits_check(numbers, self.cell["check"]["limits"])


class _Tally:
    """The check's numbers over one set of answers."""

    def __init__(self):
        self.err = self.order = 0.0
        self.found, self.n_q, self.short, self.checked = 0.0, 0, 0, 0
        self.deepest = -1

    def numbers(self) -> dict:
        recall = self.found / self.n_q if self.n_q else 0.0
        return {"fuse_err": self.err, "vec_order": self.order,
                "miss_share": 1.0 - recall, "short_pages": self.short,
                "checked": self.checked}


def _need(r) -> int:
    """The length of the lists the program fuses for a request."""
    return max(r.offset + r.length, 20)


def _lex_terms(d: int, sc: np.ndarray, want: np.ndarray,
               need: int) -> list[float]:
    """The lexical terms doc `d` can carry: 1 / (0.6 + r) for each rank r
    whose reference score lies within TIE of d's, and 0 where d does not
    match or can lie below a full list."""
    s = float(sc[d]) if 0 <= d < len(sc) else float("-inf")
    if not np.isfinite(s):
        return [0.0]
    out = [1.0 / (hybrid.RRF_K + r) for r, w in enumerate(want.tolist())
           if abs(s - w) <= TIE * abs(w)]
    if len(want) == need and s <= want[-1] + TIE * abs(want[-1]):
        out.append(0.0)
    return out or [0.0]


def _reading(d: int, s: float, sc, want, need: int, vector: bool):
    """(the least relative gap of score `s` from a sum l + v, the vector
    rank that sum implies: None for v = 0, -1 where sums of more than one
    rank come as close)."""
    ls = np.array(_lex_terms(d, sc, want, need))
    v = np.array([0.0] + ([1.0 / (hybrid.RRF_K + r) for r in range(need)]
                          if vector else []))
    gaps = np.abs(s - ls[:, None] - v[None, :]).min(axis=0) / max(
        abs(s), 1e-300)
    at = np.flatnonzero(gaps <= gaps.min() + MATCH).tolist()
    rank = None if at == [0] else (at[0] - 1 if len(at) == 1 else -1)
    return float(gaps.min()), rank


def _page(ids, scores, sc, want, need: int, near: dict, doc_scores,
          ranked):
    """(fuse_err, vec_order, the deepest exact rank of a doc whose score
    needs a vector term, -1 where none does) of one served page; `near`
    maps the exact top NEAR docs to their exact ranks, `doc_scores(docs)`
    gives each doc's (best, worst) i8 row score, `ranked` is the i8 list
    (ids, best scores) one deeper than the page's lists."""
    if len(set(ids)) != len(ids):
        return float("inf"), float("inf"), -1
    for a in range(len(ids) - 1):
        if (scores[a], -ids[a]) <= (scores[a + 1], -ids[a + 1]):
            return float("inf"), float("inf"), -1
    err, deepest, claims = 0.0, -1, {}
    for d, s in zip(ids, scores):
        gap, rank = _reading(int(d), s, sc, want, need, int(d) in near)
        err = max(err, gap)
        if rank is not None and rank >= 0:
            deepest = max(deepest, near[int(d)])
            if rank in claims.values():
                return err, float("inf"), deepest
            claims[int(d)] = rank
    rows = doc_scores(list(claims))
    if set(rows) != set(claims):
        return err, float("inf"), deepest
    order = 0.0
    for d, r in claims.items():
        best, worst = rows[d]
        if r:
            others = [x for o, x in zip(*ranked) if int(o) != d]
            order = max(order, worst - others[r - 1])
        for d2, r2 in claims.items():
            if r < r2:
                order = max(order, rows[d2][1] - best)
    return err, order, deepest
