"""The ``vector`` kind of deployment: one vector field, Euclidean, i8 scalar
quantization, IVF clustering.

Its committed index is the configuration's generated rows; each run
ingests a tail of rows drawn near the same centres, sends the pool's query
vectors and judges what the window served against
``reference/vectors.py``.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np

from gen import traffic, vectors
from harness.recorder import Recorder, limits_check
from harness.requests import search_requests
from reference.vectors import VectorReference

KIND = "vector"
# (configuration sizes, cell sizes) of the CPU tests
TINY = ({"n_vectors": 12_000}, {"pool": 96, "batch": 32, "tail": 200})


def _rows(config: dict, rng, n: int):
    centers = vectors.proxy_centers(config["dataset"], config["data_seed"])
    return vectors.rows_near(config["dataset"], centers, n, rng)


def pool(cell: dict, config: dict, seed: int) -> np.ndarray:
    """The cell's query pool: f32 vectors [n, d]."""
    return _rows(config, traffic.pool_rng(cell, seed), int(cell["pool"]))


def tail(cell: dict, config: dict, seed: int) -> np.ndarray:
    """The uncommitted tail every run ingests anew: f32 rows [n, d]."""
    return _rows(config, traffic.rng_for(seed, traffic.TAIL),
                 int(cell["tail"]))


class System:
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
        self.tail_rows = tail(self.cell, self.config, self.seed)
        idx.index_documents([{"vector": x} for x in self.tail_rows])
        return len(self.tail_rows)

    def requests(self, st) -> list:
        self.pool = pool(self.cell, self.config, self.seed)
        self.reqs = search_requests(
            st, self.cell, [dict(query_vector=v.tolist()) for v in self.pool])
        return self.reqs

    def readings(self, idx, device: str) -> dict:
        """The uploaded index's clusters and rows, which
        ``kernels.roofline_pct.vec`` reads beside the served work."""
        import torch

        dev_state = idx.vectors.device(idx.shards[0], torch.device(device))
        return dict(n_clusters=int(dev_state["n_clusters"]),
                    n_rows=int(dev_state["n_rows"]),
                    dim=int(self.config["vector"]["dim"]))

    def recorder(self) -> Recorder:
        return Recorder(traffic.check_sample(self.cell, self.seed),
                        keep_all=True)

    def work(self, served: np.ndarray) -> dict:
        return {"queries": int(served.sum())}

    def reference(self, levels: int = 255) -> VectorReference:
        if getattr(self, "_ref_base", None) is None:
            self._ref_base = self._base()
        return VectorReference(self._ref_base, self.tail_rows, levels)

    def judge(self, rec: Recorder, device: str,
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
        return numbers, limits_check(numbers, self.cell["check"]["limits"])


def _dist_err(ref_d: np.ndarray, got: np.ndarray) -> float:
    if len(ref_d) != len(got) or not np.all(np.isfinite(ref_d)):
        return float("inf")
    err = np.abs(got - ref_d) / np.maximum(ref_d, 1e-9)
    order = np.maximum(ref_d[:-1] - ref_d[1:], 0) / np.maximum(ref_d[1:], 1e-9)
    return float(max(err.max(initial=0.0), order.max(initial=0.0)))
