"""The ``hybrid`` kind at the CPU's sizes: found by its name, the judge
correct on the port's pages, and not correct on its control (bf16 BM25F and
4-bit vector rows in the program's place), on the 4-bit vector rows alone,
on a page with a doc's vector term counted twice, on vector ranks counted
from 1, on two docs of a page on one vector rank and on a page with an id
twice."""

from collections import Counter

import numpy as np
import pytest

from harness import files
from harness.recorder import limits_check
from test_bench_port_kinds import drive

CELL = "wikihybrid1m.rrf_b128"
SEED = 2**31 + 91


@pytest.fixture(scope="module")
def served(cache):
    return drive(CELL, cache, seed=SEED, batches=4)


def _correct(system, numbers) -> bool:
    check = limits_check(numbers, system.cell["check"]["limits"])
    return all(v["value"] <= v["limit"] for v in check.values())


def _altered(rec, change):
    """A copy of the recorder with each sampled page passed through
    `change(pool index, ids, scores)`."""
    out = type(rec)(rec.sample, rec.keep_all, rec.key)
    for pi, answers in rec.all_answers.items():
        for (ids, scores, count), times in answers.items():
            ids, scores = change(pi, list(ids), list(scores))
            key = (tuple(ids), tuple(scores), count)
            out.all_answers.setdefault(pi, Counter())[key] += times
            if pi in rec.answers:
                out.answers.setdefault(pi, Counter())[key] += times
    return out


def test_the_hybrid_kind_is_found_by_its_name():
    mod = files.load_kind("hybrid")
    assert mod.KIND == "hybrid"
    for attr in ("TINY", "pool", "tail", "System"):
        assert hasattr(mod, attr), attr


def test_the_ports_pages_are_correct(served):
    system, _, _, rec, _ = served
    numbers, _ = system.judge(rec, "cpu")
    assert numbers["checked"] > 0
    assert numbers["fuse_err"] < 1e-12
    assert _correct(system, numbers), numbers


def test_the_control_is_not_correct(served):
    system, _, _, rec, _ = served
    numbers, _ = system.judge(rec, "cpu", control=True)
    assert not _correct(system, numbers), numbers


def test_the_4bit_vectors_alone_are_not_correct(served):
    """The f32 BM25F list fused with the 4-bit rows' list: the pages'
    vector ranks contradict the i8 rows' scores."""
    system, _, _, rec, _ = served
    system.judge(rec, "cpu", control=True)
    numbers = system.numbers["4-bit vectors alone"]
    assert numbers["fuse_err"] < 1e-12
    assert numbers["vec_order"] > system.cell["check"]["limits"]["vec_order"]
    assert not _correct(system, numbers), numbers


def _shift_vector_terms(system, rec, move):
    """A change of each sampled page: every entry whose score reads as one
    lexical term plus the vector term of rank r gets `move(r, doc, page's
    readings)`'s rank's term instead (None: left as it is); the page is put
    back in (score desc, doc asc) order."""
    kind = files.load_kind("hybrid")
    hybrid = kind.hybrid
    lex = system.lexical("f32", True)

    def change(pi, ids, scores):
        if pi not in rec.answers:
            return ids, scores
        _, want, sc = hybrid.lexical_page(lex, *system.pool[pi], 20)
        ranks = [kind._reading(d, s, sc, want, 20, True)[1]
                 for d, s in zip(ids, scores)]
        for i, d in enumerate(ids):
            to = move(ranks[i], d, ranks)
            if to is not None:
                was = 0.0 if ranks[i] is None else 1.0 / (hybrid.RRF_K
                                                          + ranks[i])
                scores[i] += 1.0 / (hybrid.RRF_K + to) - was
        order = sorted(range(len(ids)), key=lambda i: (-scores[i], ids[i]))
        return [ids[i] for i in order], [scores[i] for i in order]
    return change


def test_vector_ranks_from_1_are_not_correct(served):
    """Each vector term 1 / (1.6 + r) in place of 1 / (0.6 + r): every
    score still reads as a sum of terms, of the rank below."""
    system, _, _, rec, _ = served
    change = _shift_vector_terms(
        system, rec, lambda r, d, ranks: r + 1 if r is not None and r >= 0
        else None)
    numbers, _ = system.judge(_altered(rec, change), "cpu")
    assert numbers["fuse_err"] < 1e-12
    assert numbers["vec_order"] > system.cell["check"]["limits"]["vec_order"]
    assert not _correct(system, numbers)


def test_two_docs_on_one_vector_rank_are_not_correct(served):
    """Where a page holds a doc on vector rank r and one among the exact
    top NEAR with no vector term, the second gets rank r's term too."""
    system, _, _, rec, _ = served
    kind = files.load_kind("hybrid")
    entries = sorted(rec.answers)
    q = system.query_vectors(entries)
    near = {pi: set(ids.tolist()) for pi, (ids, _) in zip(
        entries, system.vectors("cpu").top(q, kind.NEAR))}
    page = {}

    def move(r, d, ranks):
        pi = page["pi"]
        taken = [x for x in ranks if x is not None and x >= 0]
        if r is None and taken and d in near[pi] and not page.get("done"):
            page["done"] = True
            return taken[0]
        return None

    shift = _shift_vector_terms(system, rec, move)

    def change(pi, ids, scores):
        page.update(pi=pi, done=False)
        return shift(pi, ids, scores)

    numbers, _ = system.judge(_altered(rec, change), "cpu")
    assert numbers["vec_order"] == np.inf
    assert not _correct(system, numbers)


def test_a_doubled_vector_term_is_not_correct(served):
    """Each sampled page's first entry that carries a vector term gets it
    twice; the page is put back in (score desc, doc asc) order."""
    system, _, _, rec, _ = served
    kind = files.load_kind("hybrid")
    hybrid = kind.hybrid
    lex = system.lexical("f32", True)
    v_set = [1.0 / (hybrid.RRF_K + r) for r in range(20)]

    def change(pi, ids, scores):
        if pi not in rec.answers:
            return ids, scores
        _, want, sc = hybrid.lexical_page(lex, *system.pool[pi], 20)
        for i, (d, s) in enumerate(zip(ids, scores)):
            v = [s - l for l in kind._lex_terms(d, sc, want, 20)
                 if any(abs(s - l - x) < 1e-12 for x in v_set)]
            if v and v[0] > 0:
                scores[i] = s + v[0]
                break
        order = sorted(range(len(ids)), key=lambda i: (-scores[i], ids[i]))
        return [ids[i] for i in order], [scores[i] for i in order]

    numbers, _ = system.judge(_altered(rec, change), "cpu")
    assert numbers["fuse_err"] > system.cell["check"]["limits"]["fuse_err"]
    assert not _correct(system, numbers)


def test_an_id_twice_is_not_correct(served):
    system, _, _, rec, _ = served

    def change(pi, ids, scores):
        return ids[:1] * 2 + ids[2:], scores
    numbers, _ = system.judge(_altered(rec, change), "cpu")
    assert numbers["fuse_err"] == np.inf
    assert not _correct(system, numbers)
