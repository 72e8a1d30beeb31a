"""The vector generator of the repository's root ``bench_vector.py``, copied
so that the yardstick does not move when the program does, and the draws
that put a run's queries and uncommitted rows near the same centres.
"""

from __future__ import annotations

import numpy as np

# dataset -> (dimension, centres, noise, value ceiling), bench_vector.py
PROXIES = {"sift": (128, 1024, 18.0, 255.0), "gist": (960, 512, 0.035, 1.0)}


def make_proxy(dataset: str, n: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """``bench_vector.make_proxy``: (base [n, d], queries [4096, d]) with
    SIFT- or GIST-like statistics, the same arrays for the same generator."""
    if dataset == "sift":
        d, n_centers, noise, hi = 128, 1024, 18.0, 255.0
    else:
        d, n_centers, noise, hi = 960, 512, 0.035, 1.0
    centers = rng.uniform(0, hi * 0.8, size=(n_centers, d)).astype(np.float32)
    out = np.empty((n, d), np.float32)
    step = 131072
    for a in range(0, n, step):
        b = min(a + step, n)
        ci = rng.integers(0, n_centers, size=b - a)
        x = centers[ci] + rng.normal(
            0, noise, size=(b - a, d)).astype(np.float32)
        np.clip(x, 0, hi, out=x)
        if dataset == "sift":
            np.rint(x, out=x)
        out[a:b] = x
    qi = rng.integers(0, n_centers, size=4096)
    q = centers[qi[:4096]] + rng.normal(
        0, noise, size=(4096, d)).astype(np.float32)
    np.clip(q, 0, hi, out=q)
    if dataset == "sift":
        np.rint(q, out=q)
    return out, q


def proxy_centers(dataset: str, data_seed: int) -> np.ndarray:
    """The centres that ``make_proxy(dataset, n, default_rng(data_seed))``
    draws first."""
    d, n_centers, _, hi = PROXIES[dataset]
    rng = np.random.default_rng(data_seed)
    return rng.uniform(0, hi * 0.8, size=(n_centers, d)).astype(np.float32)


def rows_near(dataset: str, centers: np.ndarray, n: int, rng) -> np.ndarray:
    """n rows drawn as ``make_proxy`` draws its queries: a random centre plus
    noise, clipped (and rounded for SIFT)."""
    d, n_centers, noise, hi = PROXIES[dataset]
    ci = rng.integers(0, n_centers, size=n)
    x = centers[ci] + rng.normal(0, noise, size=(n, d)).astype(np.float32)
    np.clip(x, 0, hi, out=x)
    if dataset == "sift":
        np.rint(x, out=x)
    return x
