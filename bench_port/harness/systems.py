"""The two kinds of deployment the configurations describe, as the harness
drives them: ``text`` (title and body fields, BM25F) and ``vector`` (one
vector field, Euclidean, i8 scalar quantization, IVF clustering).

Each kind builds its committed index once per cache directory, opens it,
ingests the run's tail, turns the pool into requests, records what the
window served and judges it against the plain reference afterwards.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np

from gen import corpus, traffic, vectors
from reference import bm25f
from reference.vectors import VectorReference


def _requests(st, cell: dict, base: list[dict]) -> list:
    """SearchRequests from the cell's ``request`` settings plus each pool
    entry's own fields."""
    r = dict(cell["request"])
    kw = dict(length=int(r.get("length", 10)),
              realtime=bool(r.get("realtime", True)),
              result_type=st.ResultType[r.get("result_type", "TopkCount")])
    for key in ("ann_mode", "nprobe", "top_n"):
        if key in r:
            kw[key] = r[key]
    if "search_mode" in r:
        kw["search_mode"] = st.SearchMode[r["search_mode"]]
    return [st.SearchRequest(**kw, **b) for b in base]


def _limits_check(numbers: dict, limits: dict) -> dict:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


class TextSystem:
    kind = "text"

    def __init__(self, config: dict, cell: dict, seed: int):
        self.config, self.cell, self.seed = config, cell, seed
        self.vocab = int(config["vocab"])

    # -- the cached committed index --------------------------------------
    def build(self, st, where: Path, device: str) -> None:
        c = self.config
        arrays = corpus.corpus_tokens(int(c["n_docs"]), self.vocab,
                                      np.random.default_rng(c["data_seed"]))
        bm25f.postings(*arrays, self.vocab).save(where / "committed.npz")
        schema = [st.SchemaField(f["name"], st.FieldType.Text, indexed=True,
                                 boost=float(f["boost"]))
                  for f in c["fields"]]
        idx = st.create_index(where / "index", schema,
                              shard_count=int(c["shards"]), device=device)
        docs = corpus.docs_from_tokens(*arrays)
        del arrays
        step = int(c.get("ingest_step", 1 << 17))
        for a in range(0, len(docs), step):
            idx.index_documents(docs[a:a + step])
        idx.commit()
        del idx

    def load_reference(self, where: Path) -> None:
        self.committed = bm25f.Postings.load(where / "committed.npz")

    def open(self, st, where: Path, device: str):
        self.load_reference(where)
        return st.open_index(where / "index", device=device)

    def ingest_tail(self, idx) -> int:
        self.tail_arrays = traffic.tail(self.cell, self.config, self.seed)
        docs = corpus.docs_from_tokens(*self.tail_arrays)
        idx.index_documents(docs)
        return len(docs)

    def requests(self, st) -> list:
        self.pool = traffic.pool(self.cell, self.config, self.seed)
        return _requests(st, self.cell, [
            dict(query=q, query_type_default=st.QueryType[t])
            for q, t in self.pool])

    # -- what the window served ------------------------------------------
    def recorder(self):
        return _Recorder(traffic.check_sample(self.cell, self.seed),
                         keep_all=False)

    def work(self, served: np.ndarray) -> dict:
        """Postings of the served queries' distinct terms (committed plus
        tail) and the page entries written, from the generated data."""
        tail = self.tail_postings()
        df = (np.diff(self.committed.term_off)
              + np.diff(tail.term_off)).astype(np.int64)
        per_query = np.array([
            sum(int(df[t]) for t in {int(w[1:]) for w in q.split()})
            for q, _ in self.pool], np.int64)
        n = served.astype(np.int64)
        return {"postings": int((per_query * n).sum()),
                "page_entries": int(n.sum()) * int(
                    self.cell["request"].get("length", 10)),
                "queries": int(n.sum())}

    def tail_postings(self) -> bm25f.Postings:
        if getattr(self, "_tail_p", None) is None:
            self._tail_p = bm25f.postings(*self.tail_arrays, self.vocab)
        return self._tail_p

    # -- the check --------------------------------------------------------
    def reference(self, precision: str = "f32") -> bm25f.BM25F:
        boosts = [float(f["boost"]) for f in self.config["fields"]]
        return bm25f.BM25F(self.committed, self.tail_postings(), boosts,
                           precision)

    def judge(self, rec: "_Recorder", device: str,
              control: bool = False) -> tuple[dict, dict]:
        """Numbers compared for the sampled pool entries that were served:
        page_gap (the widest share by which a served entry's reference
        score lies below the reference's entry at its rank, or by which its
        reported score misses the reference's), count_errors (where the
        request asks for a count), short_pages.
        With `control`, the bf16 reference's pages are judged instead."""
        ref = self.reference()
        low = self.reference("bf16") if control else None
        k = int(self.cell["request"].get("length", 10))
        # Topk pages carry no exact count
        counted = self.cell["request"].get("result_type") in (
            "TopkCount", "Count")
        gap, count_err, short, checked = 0.0, 0, 0, 0
        for pi, answers in sorted(rec.answers.items()):
            q, t = self.pool[pi]
            sc, cnt = ref.scores(q, t)
            want_ids, want = bm25f.page(sc, k)
            if control:
                lsc, lcnt = low.scores(q, t)
                li, ls = bm25f.page(lsc, k)
                answers = Counter({(tuple(li.tolist()), tuple(ls.tolist()),
                                    lcnt): 1})
            for (ids, scores, count), times in answers.items():
                checked += times
                count_err += times * (counted and count != cnt)
                short += times * (len(ids) != len(want_ids))
                gap = max(gap, _page_gap(ids, scores, sc, want))
        numbers = {"page_gap": gap, "count_errors": count_err,
                   "short_pages": short, "checked": checked}
        return numbers, _limits_check(numbers, self.cell["check"]["limits"])


def _page_gap(ids, scores, sc: np.ndarray, want: np.ndarray) -> float:
    """The widest relative shortfall of a served page against the
    reference's scores `sc` and the reference's own page scores `want`."""
    seen = set()
    worst = 0.0
    for i, (d, s) in enumerate(zip(ids, scores)):
        ref_s = (float(sc[d]) if 0 <= d < len(sc) and d not in seen
                 else float("-inf"))
        seen.add(d)
        if not np.isfinite(ref_s):
            return float("inf")
        if i < len(want):
            worst = max(worst, (float(want[i]) - ref_s) / abs(float(want[i])))
        worst = max(worst, abs(float(s) - ref_s) / max(abs(ref_s), 1e-30))
    return worst


class VectorSystem:
    kind = "vector"

    def __init__(self, config: dict, cell: dict, seed: int):
        self.config, self.cell, self.seed = config, cell, seed

    def _base(self) -> np.ndarray:
        c = self.config
        return vectors.make_proxy(c["dataset"], int(c["n_vectors"]),
                                  np.random.default_rng(c["data_seed"]))[0]

    def _meta(self, st):
        v = self.config["vector"]
        return st.IndexMeta(vector=st.VectorConfig(
            enabled=True, dim=int(v["dim"]),
            similarity=st.VectorSimilarity[v["similarity"]],
            precision=st.Precision[v["precision"]],
            quantization=st.Quantization[v["quantization"]],
            inference=st.InferenceType.External,
            clustering=st.ClusteringConfig(
                mode=st.ClusteringMode[v["clustering"]])))

    def build(self, st, where: Path, device: str) -> None:
        base = self._base()
        schema = [st.SchemaField("vector", st.FieldType.Json,
                                 index_vector=True)]
        idx = st.create_index(where / "index", schema, meta=self._meta(st),
                              shard_count=int(self.config["shards"]),
                              device=device)
        step = int(self.config.get("ingest_step", 8192))
        for a in range(0, len(base), step):
            idx.index_documents([{"vector": x} for x in base[a:a + step]])
        idx.commit()
        del idx

    def open(self, st, where: Path, device: str):
        return st.open_index(where / "index", device=device)

    def ingest_tail(self, idx) -> int:
        self.tail_rows = traffic.tail(self.cell, self.config, self.seed)
        idx.index_documents([{"vector": x} for x in self.tail_rows])
        return len(self.tail_rows)

    def requests(self, st) -> list:
        self.pool = traffic.pool(self.cell, self.config, self.seed)
        return _requests(st, self.cell,
                         [dict(query_vector=v.tolist()) for v in self.pool])

    def recorder(self):
        return _Recorder(traffic.check_sample(self.cell, self.seed),
                         keep_all=True)

    def work(self, served: np.ndarray) -> dict:
        return {"queries": int(served.sum())}

    def reference(self, levels: int = 255) -> VectorReference:
        if getattr(self, "_ref_base", None) is None:
            self._ref_base = self._base()
        return VectorReference(self._ref_base, self.tail_rows, levels)

    def judge(self, rec: "_Recorder", device: str,
              control: bool = False) -> tuple[dict, dict]:
        """page_err (the widest relative gap between a served distance and
        the reference's, or by which the page's reference distances fall out
        of order) over the sampled entries, miss_share (one less recall@10
        against the exact top-10, ties counted, over every served query),
        short_pages."""
        ref = self.reference()
        k = int(self.cell["request"].get("length", 10))
        thr = ref.truth(self.pool, k, device)
        all_answers = rec.all_answers
        if control:
            low = self.reference(levels=15)
            li, ld = low.exhaustive_pages(self.pool, k, device)
            all_answers = {pi: Counter({(tuple(li[pi].tolist()),
                                         tuple(ld[pi].tolist()), 0): 1})
                           for pi in rec.all_answers}
        found, n_q, short, err, checked = 0.0, 0, 0, 0.0, 0
        sample = set(rec.sample.tolist())
        for pi, answers in sorted(all_answers.items()):
            q = self.pool[pi].astype(np.float64)
            for (ids, dists, _), times in answers.items():
                n_q += times
                short += times * (len(ids) != k)
                idv = np.array(ids, np.int64)
                ok = (idv >= 0) & (idv < ref.n)
                d2 = np.array([((ref.row(i).astype(np.float64) - q) ** 2).sum()
                               for i in idv[ok]])
                found += times * min(
                    len(set(idv[ok][d2 <= thr[pi]].tolist())), k) / k
                if pi in sample:
                    checked += times
                    err = max(err, _dist_err(ref.distances(self.pool[pi], idv),
                                             np.array(dists, np.float64)))
        recall = found / n_q if n_q else 0.0
        numbers = {"page_err": err, "miss_share": 1.0 - recall,
                   "short_pages": short, "checked": checked}
        self.recall = recall
        return numbers, _limits_check(numbers, self.cell["check"]["limits"])


def _dist_err(ref_d: np.ndarray, got: np.ndarray) -> float:
    if len(ref_d) != len(got) or not np.all(np.isfinite(ref_d)):
        return float("inf")
    err = np.abs(got - ref_d) / np.maximum(ref_d, 1e-9)
    order = np.maximum(ref_d[:-1] - ref_d[1:], 0) / np.maximum(ref_d[1:], 1e-9)
    return float(max(err.max(initial=0.0), order.max(initial=0.0)))


class _Recorder:
    """Served answers by pool index: a Counter of (ids, scores, count) for
    the sampled entries (every entry with ``keep_all``), and how many
    times each pool entry was served."""

    def __init__(self, sample: np.ndarray, keep_all: bool):
        self.sample = sample
        self._in_sample = np.zeros(int(sample.max()) + 1 if len(sample)
                                   else 0, bool)
        self._in_sample[sample] = True
        self.keep_all = keep_all
        self.answers: dict[int, Counter] = {}
        self.all_answers: dict[int, Counter] = {}

    def wants(self, pi: int) -> bool:
        return self.keep_all or (pi < len(self._in_sample)
                                 and self._in_sample[pi])

    def add(self, pi: int, rs) -> None:
        key = (tuple(r.doc_id for r in rs.results),
               tuple(r.score for r in rs.results), rs.result_count_total)
        if pi < len(self._in_sample) and self._in_sample[pi]:
            self.answers.setdefault(pi, Counter())[key] += 1
        if self.keep_all:
            self.all_answers.setdefault(pi, Counter())[key] += 1

    def merge(self, other: "_Recorder") -> None:
        for mine, theirs in ((self.answers, other.answers),
                             (self.all_answers, other.all_answers)):
            for pi, c in theirs.items():
                mine.setdefault(pi, Counter()).update(c)


SYSTEMS = {"text": TextSystem, "vector": VectorSystem}
