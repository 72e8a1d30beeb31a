"""IVF clustering: k-means seeding + Lloyd iterations on a torch device,
snapped to medoids, with the reference's sizing and layout conventions.

The port's copy of ``seekstorm_tpu/clustering.py``.  The host logic (sizing,
seeding, medoid snap, layout) is the reference's; its jitted bodies are torch
ops on the device the caller names: the greedy PAM build (``_greedy``) is a
Python loop of k-1 steps over a device similarity matrix, the assignment an
argmax of chunked device matmuls, and a Lloyd step's per-cluster sums an
``index_add_`` in float64 where the reference multiplies a one-hot matrix in
float32.  A float32 product on a CUDA device runs with TF32 off, as the
reference asks ``Precision.HIGHEST`` of its TPU.

Reference behavior mirrored (reference seekstorm/src/clustering.rs:229-500,
vector.rs:969-1100): clustering runs per committed level when the level has
>= min_points vectors; k = 2*sqrt(n) for Auto; records are re-sorted by
cluster with the medoid as the first record of each cluster so nprobe
selection reads medoids for free.  The reference's PAM-style refinement is
replaced by Lloyd iterations + medoid snap.

Sums are taken in another order than the reference's XLA, so an assignment
between two centroids a few ulps apart can differ: on well-separated data
the layout equals the reference's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .ops.vector import full_f32
from .schema import ClusteringConfig, ClusteringMode, VectorSimilarity


def cluster_level(
    vecs: np.ndarray,                  # f32[N, d] (normalized for cosine)
    similarity: VectorSimilarity,
    cfg: ClusteringConfig,
    seed: int = 7,
    device="cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """Cluster one level's vectors, the device work on `device`.

    Returns (order, cluster_offsets):
      order: i64[N] permutation — rows sorted by cluster, medoid first
      cluster_offsets: i64[C+1] ranges into the permuted rows
    """
    n = len(vecs)
    if (
        cfg.mode == ClusteringMode.Null
        or n < cfg.min_points
        or n < 4
    ):
        return np.arange(n, dtype=np.int64), np.array([0, n], dtype=np.int64)

    if cfg.mode == ClusteringMode.Fixed and cfg.cluster_count > 0:
        k = min(cfg.cluster_count, n)
    else:
        k = max(1, min(int(2 * np.sqrt(n)), n))

    device = torch.device(device)
    algo = os.environ.get("SEEKSTORM_TPU_CLUSTER_ALGO", "lloyd")
    if algo == "pam":
        order, offsets = _pam_build_order(vecs, k, similarity, device)
        if order is not None:
            return order, offsets
    assign, centers = _kmeans(vecs, k, similarity, cfg.iterations, seed,
                              device)

    # medoid per cluster: nearest real vector to the center.  One argsort
    # instead of per-cluster flatnonzero (O(n log n) vs O(n*k))
    order_all = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order_all], np.arange(k + 1))
    order_chunks = []
    offsets = [0]
    x = vecs.astype(np.float32)
    for c in range(k):
        rows = order_all[bounds[c] : bounds[c + 1]]
        if len(rows) == 0:
            continue
        sims = _sim(x[rows], centers[c : c + 1], similarity)[:, 0]
        medoid = rows[int(np.argmax(sims))]
        rest = rows[rows != medoid]
        order_chunks.append(np.concatenate([[medoid], rest]))
        offsets.append(offsets[-1] + len(rows))
    order = np.concatenate(order_chunks).astype(np.int64)
    return order, np.asarray(offsets, dtype=np.int64)


def _pam_build_order(vecs, k, similarity, device):
    """Reference-style sampled greedy k-medoid BUILD
    (clustering.rs:229-500) restated as matmuls:

    * first medoid = the vector most similar to the (strided) mean;
    * each further medoid = the strided CANDIDATE maximizing
      sum_j max(0, sim(cand, j) - best_sim_so_far(j)) over a strided
      gain SAMPLE — the point whose adoption most raises total assigned
      similarity (facility-location greedy, what PAM's BUILD phase does);
    * final assignment = exact argmax over all k medoids (the reference's
      chronological switch-if-closer converges to the same thing: each
      doc keeps the max over every medoid it was compared against).

    All pairwise similarities are batched matmuls: candidates x sample
    for gains, docs x medoids (chunked) for assignment.  Returns
    (order, offsets) like cluster_level, or (None, None) when k < 2.
    """
    n = len(vecs)
    if k < 2:
        return None, None

    x = vecs.astype(np.float32)
    # reference-derived sampling (clustering.rs:241-247); the candidate
    # pool is widened to >= 2k so the fixed pool can supply every medoid
    # (the reference instead rotates a small pool's stride offset per
    # round, which forces a fresh similarity matrix per medoid)
    sample_size = max(int(n / (1.0 + n * 0.0025)), 1)
    m_step = max(n // max(sample_size, 2 * k), 1)
    v_step = max(n // sample_size // 16, 1)

    cand = np.arange(0, n, m_step)
    samp = np.arange(0, n, v_step)
    mean = x[samp].mean(axis=0, keepdims=True)
    first = int(np.argmax(_sim(x, mean, similarity)[:, 0]))

    S = torch.from_numpy(_sim(x[cand], x[samp], similarity)
                         .astype(np.float32)).to(device)       # [nc, ns]
    cur = torch.from_numpy(
        _sim(x[samp], x[first: first + 1], similarity)[:, 0]
        .astype(np.float32)).to(device)
    used = torch.from_numpy(cand == first).to(device)
    k_eff = int(min(k, len(cand)))

    # the greedy build, one step a medoid; the picks stay on the device
    picks = []
    for _ in range(k_eff - 1):
        gains = torch.clamp(S - cur[None, :], min=0.0).sum(dim=1)
        gains = torch.where(used, float("-inf"), gains)
        ci = torch.argmax(gains)
        used[ci] = True
        picks.append(ci)
        cur = torch.maximum(cur, S[ci])
    meds_ci = (torch.stack(picks).cpu().numpy() if picks
               else np.zeros(0, np.int64))
    med = np.concatenate([[first], cand[meds_ci]]).astype(np.int64)
    # the used-mask guarantees distinct pool entries; `first` could
    # coincide with a pool entry only if the mask missed it
    med = med[np.sort(np.unique(med, return_index=True)[1])]
    assign = _assign_nearest(x, x[med], similarity, device)
    # docs sorted by cluster, medoid first (same layout as cluster_level)
    order_all = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order_all], np.arange(len(med) + 1))
    order_chunks = []
    offsets = [0]
    for c in range(len(med)):
        rows = order_all[bounds[c]: bounds[c + 1]]
        if len(rows) == 0:
            continue
        mrow = med[c]
        if (rows == mrow).any():
            chunk = np.concatenate([[mrow], rows[rows != mrow]])
        else:
            # an identical twin medoid won the argmax tie; the cluster's
            # first row serves as its representative
            chunk = rows
        order_chunks.append(chunk)
        offsets.append(offsets[-1] + len(chunk))
    order = np.concatenate(order_chunks).astype(np.int64)
    return order, np.asarray(offsets, np.int64)


def _chunk_rows(n: int, k: int) -> int:
    """Rows of a device step: the [rows, k] similarity matrix stays within
    2^28 entries (1 GB; global re-clustering runs at millions x thousands)."""
    chunk = n
    while chunk * k > (1 << 28):
        chunk //= 2
    return max(chunk, 1 << 14)


def _assign_nearest(x, medvecs, similarity, device):
    """argmax-similarity assignment of every row to a medoid (chunked
    device matmuls, same tiling rules as the Lloyd step)."""
    n = len(x)
    chunk = _chunk_rows(n, len(medvecs))
    C = torch.from_numpy(medvecs.astype(np.float32)).to(device)
    assign = np.zeros(n, np.int64)
    with full_f32():
        for a in range(0, n, chunk):
            xc = torch.from_numpy(x[a: a + chunk]).to(device)
            assign[a: a + chunk] = torch.argmax(
                _sim_t(xc, C, similarity), dim=1).cpu().numpy()
    return assign


def _sim(a: np.ndarray, b: np.ndarray, similarity: VectorSimilarity) -> np.ndarray:
    """Similarity (higher = closer) between rows of a [n,d] and b [m,d]."""
    dots = a @ b.T
    if similarity == VectorSimilarity.Euclidean:
        na = (a * a).sum(axis=1)[:, None]
        nb = (b * b).sum(axis=1)[None, :]
        return -(na + nb - 2 * dots)
    return dots


def _kmeans(
    x: np.ndarray, k: int, similarity: VectorSimilarity, iters: int,
    seed: int, device,
) -> tuple[np.ndarray, np.ndarray]:
    """Device k-means (torch matmuls) with kmeans++-lite seeding."""
    n, d = x.shape
    rng = np.random.default_rng(seed)
    # subsample for seeding/refinement on very large levels (reference
    # subsamples similarly, clustering.rs:241-247)
    sample = min(n, max(4 * k, 4096))
    sub = rng.choice(n, size=sample, replace=False) if sample < n else np.arange(n)

    # seeding: start from the vector nearest the mean (reference
    # clustering.rs:260-315), then greedy farthest-point on the subsample
    xs = x[sub]
    mean = xs.mean(axis=0, keepdims=True)
    first = int(np.argmax(_sim(xs, mean, similarity)[:, 0]))
    centers = [xs[first]]
    best_sim = _sim(xs, xs[first : first + 1], similarity)[:, 0]
    for _ in range(k - 1):
        nxt = int(np.argmin(best_sim))
        centers.append(xs[nxt])
        best_sim = np.maximum(best_sim, _sim(xs, xs[nxt : nxt + 1], similarity)[:, 0])
    C = np.stack(centers).astype(np.float32)

    # tile the Lloyd step so the [n, k] similarity matrix fits the device
    chunk = _chunk_rows(n, k)
    Cj = torch.from_numpy(C).to(device)
    xchunks = [torch.from_numpy(np.ascontiguousarray(x[a : a + chunk]))
               .to(device) for a in range(0, n, chunk)]
    assign = np.zeros(n, np.int64)
    for _ in range(max(iters, 1)):
        sums = torch.zeros((k, d), dtype=torch.float64, device=device)
        counts = torch.zeros(k, dtype=torch.float64, device=device)
        pos = 0
        with full_f32():
            for xc in xchunks:
                a = torch.argmax(_sim_t(xc, Cj, similarity), dim=1)
                sums.index_add_(0, a, xc.double())
                counts += torch.bincount(a, minlength=k).double()
                assign[pos : pos + len(a)] = a.cpu().numpy()
                pos += len(a)
        sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
        newC = np.where(counts[:, None] > 0,
                        sums / np.maximum(counts[:, None], 1),
                        Cj.cpu().numpy())
        Cj = torch.from_numpy(newC.astype(np.float32)).to(device)
    return assign, Cj.cpu().numpy()


def _sim_t(a, b, similarity: VectorSimilarity):
    """_sim on torch tensors."""
    dots = a @ b.T
    if similarity == VectorSimilarity.Euclidean:
        na = (a * a).sum(dim=1)[:, None]
        nb = (b * b).sum(dim=1)[None, :]
        return -(na + nb - 2 * dots)
    return dots
