"""The ``text`` kind of deployment: title and body fields, BM25F.

Its committed index is the configuration's generated corpus; each run
ingests a tail of generated documents, sends the cell's query mix and judges
what the window served against ``reference/bm25f.py``.  A request with
``realtime`` false is judged over the committed documents alone: the page,
the count, and N and df of the idf leave the tail out, as the port does.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np

from gen import corpus, traffic
from harness.recorder import Recorder, limits_check
from harness.requests import search_requests
from reference import bm25f

KIND = "text"
# (configuration sizes, cell sizes) of the CPU tests
TINY = ({"n_docs": 20_000}, {"pool": 192, "batch": 64, "tail": 200})


def pool(cell: dict, config: dict, seed: int) -> list[tuple[str, str]]:
    """The cell's query pool: (query, type) pairs drawn by its ``mix``."""
    return traffic.text_queries(int(cell["pool"]),
                                traffic.pool_rng(cell, seed),
                                cell["mix"])


def tail(cell: dict, config: dict, seed: int):
    """The uncommitted tail every run ingests anew: corpus.corpus_tokens
    arrays."""
    return corpus.corpus_tokens(int(cell["tail"]), int(config["vocab"]),
                                traffic.rng_for(seed, traffic.TAIL))


class System:
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

    def open(self, st, where: Path, device: str):
        self.committed = bm25f.Postings.load(where / "committed.npz")
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
        """Device state the metrics read besides the served work: none."""
        return {}

    # -- what the window served ------------------------------------------
    def recorder(self) -> Recorder:
        return Recorder(traffic.check_sample(self.cell, self.seed),
                        keep_all=False)

    def work(self, served: np.ndarray) -> dict:
        """Postings of the served queries' distinct terms (committed, plus
        the tail's where the request is realtime) and the page entries
        written, from the generated data."""
        df_c = np.diff(self.committed.term_off).astype(np.int64)
        df_t = np.diff(self.tail_postings().term_off).astype(np.int64)
        per_query = np.array([
            sum(int(df_c[t]) + (int(df_t[t]) if r.realtime else 0)
                for t in {int(w[1:]) for w in q.split()})
            for (q, _), r in zip(self.pool, self.reqs)], np.int64)
        length = np.array([r.length for r in self.reqs], np.int64)
        n = served.astype(np.int64)
        return {"postings": int((per_query * n).sum()),
                "page_entries": int((length * n).sum()),
                "queries": int(n.sum())}

    def tail_postings(self) -> bm25f.Postings:
        if getattr(self, "_tail_p", None) is None:
            self._tail_p = bm25f.postings(*self.tail_arrays, self.vocab)
        return self._tail_p

    # -- the check --------------------------------------------------------
    def reference(self, precision: str = "f32",
                  realtime: bool = True) -> bm25f.BM25F:
        """The plain BM25F over the committed documents, plus the tail's
        where `realtime` (else an empty tail: nothing of it is scored,
        counted or in the idf)."""
        boosts = [float(f["boost"]) for f in self.config["fields"]]
        tail_p = self.tail_postings() if realtime else bm25f.Postings(
            term_off=np.zeros(self.vocab + 1, np.int64),
            doc=np.zeros(0, np.int32), tf=np.zeros((0, 2), np.uint16),
            codes=np.zeros((0, 2), np.uint8))
        return bm25f.BM25F(self.committed, tail_p, boosts, precision)

    def judge(self, rec: Recorder, device: str,
              control: bool = False) -> tuple[dict, dict]:
        """Numbers compared for the sampled pool entries that were served:
        page_gap (the widest share by which a served entry's reference
        score lies below the reference's entry at its rank, or by which its
        reported score misses the reference's), count_errors (where the
        request asks for a count), short_pages.
        With `control`, the bf16 reference's pages are judged instead."""
        refs = {}

        def ref(precision, realtime):
            if (precision, realtime) not in refs:
                refs[precision, realtime] = self.reference(precision,
                                                           realtime)
            return refs[precision, realtime]

        gap, count_err, short, checked = 0.0, 0, 0, 0
        for pi, answers in sorted(rec.answers.items()):
            q, t = self.pool[pi]
            r = self.reqs[pi]
            # Topk pages carry no exact count
            counted = r.result_type.value in ("TopkCount", "Count")
            sc, cnt = ref("f32", r.realtime).scores(q, t)
            want_ids, want = bm25f.page(sc, r.length)
            if control:
                lsc, lcnt = ref("bf16", r.realtime).scores(q, t)
                li, ls = bm25f.page(lsc, r.length)
                answers = Counter({(tuple(li.tolist()), tuple(ls.tolist()),
                                    lcnt): 1})
            for (ids, scores, count), times in answers.items():
                checked += times
                count_err += times * (counted and count != cnt)
                short += times * (len(ids) != len(want_ids))
                gap = max(gap, _page_gap(ids, scores, sc, want))
        numbers = {"page_gap": gap, "count_errors": count_err,
                   "short_pages": short, "checked": checked}
        return numbers, limits_check(numbers, self.cell["check"]["limits"])


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
