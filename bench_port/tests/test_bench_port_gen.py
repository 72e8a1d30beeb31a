"""The copied generators give what the repository's root generators give,
and the run's own draws depend on the seed alone."""

import numpy as np
import pytest

import bench
import bench_vector
from gen import corpus, traffic, vectors
from harness import files

BENCH_MIX = {"union2_below": 0.55, "intersection2_below": 0.85,
             "rank_lo": 20, "rank_hi": 3000}


@pytest.mark.parametrize("seed", [7, 8, 2**31 + 5])
def test_make_corpus_equals_root(seed):
    want = bench.make_corpus(1500, 30_000, np.random.default_rng(seed))
    got = corpus.make_corpus(1500, 30_000, np.random.default_rng(seed))
    assert got == want


def test_corpus_tokens_spell_the_documents():
    tl, bl, s = corpus.corpus_tokens(300, 30_000, np.random.default_rng(3))
    docs = corpus.docs_from_tokens(tl, bl, s)
    words = [f"w{t:05d}" for t in s.tolist()]
    pos = 0
    for d, a, b in zip(docs, tl.tolist(), bl.tolist()):
        assert d["title"].split() == words[pos:pos + a]
        assert d["body"].split() == words[pos + a:pos + a + b]
        pos += a + b


@pytest.mark.parametrize("seed", [100, 2**31 + 9])
def test_text_queries_equal_make_queries(seed):
    want = bench.make_queries(500, np.random.default_rng(seed))
    assert traffic.text_queries(500, np.random.default_rng(seed),
                                BENCH_MIX) == want


def test_make_proxy_equals_root():
    want = bench_vector.make_proxy("sift", 2000, np.random.default_rng(11))
    got = vectors.make_proxy("sift", 2000, np.random.default_rng(11))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_rows_near_the_proxy_centres():
    centers = vectors.proxy_centers("sift", 11)
    base, _ = vectors.make_proxy("sift", 500, np.random.default_rng(11))
    rows = vectors.rows_near("sift", centers, 500, np.random.default_rng(1))
    for x in (base, rows):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1).min(1) ** 0.5
        # noise 18 a coordinate over 128 dimensions: about 204 from a centre
        assert np.median(d) < 230


def test_draws_depend_on_the_seed_only():
    cell = {"pool": 64, "batch": 16, "tail": 20, "mix": BENCH_MIX,
            "check": {"sample": 10}}
    config = {"kind": "text", "vocab": 30_000}
    text = files.load_kind("text")
    assert text.pool(cell, config, 5) == text.pool(cell, config, 5)
    assert text.pool(cell, config, 5) != text.pool(cell, config, 6)
    a = [next(traffic.client_batches(cell, 5, 0)) for _ in range(2)]
    assert np.array_equal(a[0], a[1])
    assert not np.array_equal(next(traffic.client_batches(cell, 5, 0)),
                              next(traffic.client_batches(cell, 5, 1)))
    s = traffic.check_sample(cell, 2**31 + 3)
    assert len(s) == 10 and np.all(np.diff(s) > 0)


LEX = ["wiki1m.topkcount_b512", "wiki1m.topkcount_b512_committed"]


@pytest.mark.parametrize("kind", ["text", "vector"])
def test_a_pool_seed_gives_every_seed_one_pool(kind):
    cell = {"pool": 32, "batch": 8, "tail": 20, "mix": BENCH_MIX,
            "check": {"sample": 10}}
    config = ({"kind": "text", "vocab": 30_000} if kind == "text" else
              files.load_config("sift1m"))
    mod = files.load_kind(kind)

    def same(a, b):
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        return (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b)
    fixed = dict(cell, pool_seed=17)
    assert same(mod.pool(fixed, config, 5), mod.pool(fixed, config, 6))
    assert not same(mod.pool(cell, config, 5), mod.pool(cell, config, 6))
    # the tail still follows the run's seed
    assert not same(mod.tail(fixed, config, 5), mod.tail(fixed, config, 6))


@pytest.mark.parametrize("pool,batch", [(64, 16), (40, 16), (10, 16)])
def test_the_epoch_schedule_sends_each_query_once_an_epoch(pool, batch):
    cell = {"pool": pool, "batch": batch, "schedule": "epochs"}
    epochs = 3 * batch // np.gcd(pool, batch)
    n_batches = epochs * pool // batch
    sends = traffic.client_batches(cell, 5, 0)
    got = np.concatenate([next(sends) for _ in range(n_batches)])
    assert all(len(b) == batch for b in [next(sends)])
    counts = np.bincount(got, minlength=pool)
    assert np.all(counts == epochs)
    for e in range(epochs):
        assert sorted(got[e * pool:(e + 1) * pool]) == list(range(pool))
    again = traffic.client_batches(cell, 5, 0)
    assert np.array_equal(next(again), got[:batch])
    other = traffic.client_batches(cell, 6, 0)
    assert not np.array_equal(next(other), got[:batch])


def test_an_unknown_schedule_is_refused():
    with pytest.raises(ValueError, match="unknown schedule 'poisson'"):
        next(traffic.client_batches({"pool": 8, "batch": 4,
                                     "schedule": "poisson"}, 5, 0))


@pytest.mark.parametrize("name", LEX)
def test_the_lexical_cells_serve_one_pool_in_epochs(name):
    cell = files.load_cell(name)
    config = files.load_config(cell["config"])
    assert cell["schedule"] == "epochs" and "pool_seed" in cell
    text = files.load_kind(config["kind"])
    small = dict(cell, pool=256)
    assert text.pool(small, config, 2**31 + 5) == text.pool(small, config,
                                                            3 * 2**31 + 7)
