"""``wiki1m.topkcount_b512_committed``: requests with ``realtime`` false are
judged over the committed documents alone.  The port's own answers pass at
the CPU's sizes; a page that holds a tail document, a count that takes the
tail in, or scores whose idf counts the tail's documents fail; the served
work counts committed postings only."""

import copy
import dataclasses
from collections import Counter

import numpy as np
import pytest

from harness import files
from harness.recorder import Recorder
from test_bench_port_kinds import drive

CELL = "wiki1m.topkcount_b512_committed"


@pytest.fixture(scope="module")
def served(cache):
    return drive(CELL, cache)


def test_the_cell_is_wiki1m_with_realtime_false():
    mine, theirs = (files.load_cell(n) for n in
                    (CELL, "wiki1m.topkcount_b512"))
    assert mine["request"] == dict(theirs["request"], realtime=False)
    for key in ("config", "chips", "clients", "batch", "pool", "tail",
                "mix", "check", "end_to_end"):
        assert mine[key] == theirs[key], key


def test_the_ports_committed_answers_pass(served):
    system, _, _, rec, _ = served
    assert all(not r.realtime for r in system.reqs)
    numbers, check = system.judge(rec, "cpu")
    assert numbers["checked"] > 0
    assert all(v["value"] <= v["limit"] for v in check.values()), check


def _tail_hit(system, rec):
    """A sampled, served pool entry with a non-empty page whose query
    matches some tail documents: (pool index, its answer, the tail
    documents it matches)."""
    n_c = system.committed.n_docs
    with_tail = system.reference("f32", realtime=True)
    for pi, answers in sorted(rec.answers.items()):
        key = next(iter(answers))
        sc, _ = with_tail.scores(*system.pool[pi])
        hits = n_c + np.flatnonzero(np.isfinite(sc[n_c:]))
        if key[0] and len(hits):
            return pi, key, hits
    raise AssertionError("no sampled query matches a tail document")


def _judge_one(system, rec, pi, key):
    one = Recorder(rec.sample, keep_all=False)
    one.answers = {pi: Counter({key: 1})}
    return system.judge(one, "cpu")[0]


def test_a_served_tail_document_fails(served):
    system, _, _, rec, _ = served
    pi, (ids, scores, count), hits = _tail_hit(system, rec)
    assert _judge_one(system, rec, pi, (ids, scores, count))["page_gap"] \
        <= 1e-4
    planted = (ids[:-1] + (int(hits[0]),), scores, count)
    assert _judge_one(system, rec, pi, planted)["page_gap"] == float("inf")


def test_a_count_that_takes_the_tail_in_fails(served):
    system, _, _, rec, _ = served
    pi, (ids, scores, count), hits = _tail_hit(system, rec)
    planted = (ids, scores, count + len(hits))
    assert _judge_one(system, rec, pi, planted)["count_errors"] == 1


def test_the_committed_answers_fail_a_judge_that_scores_the_tail(served):
    """The same answers judged as realtime requests: the idf's N and df
    then count the tail, so the scores (and counts) differ."""
    system, _, _, rec, _ = served
    realtime = copy.copy(system)
    realtime.reqs = [dataclasses.replace(r, realtime=True)
                     for r in system.reqs]
    numbers, check = realtime.judge(rec, "cpu")
    assert not all(v["value"] <= v["limit"] for v in check.values())
    assert numbers["page_gap"] > 1e-4


def test_the_work_counts_committed_postings_only(served):
    system, _, _, _, counts = served
    committed = system.work(counts)
    realtime = copy.copy(system)
    realtime.reqs = [dataclasses.replace(r, realtime=True)
                     for r in system.reqs]
    both = realtime.work(counts)
    assert committed["queries"] == both["queries"] > 0
    assert committed["page_entries"] == both["page_entries"]
    df_c = np.diff(system.committed.term_off)
    want = sum(int(n) * sum(int(df_c[t]) for t in
                            {int(w[1:]) for w in system.pool[pi][0].split()})
               for pi, n in enumerate(counts) if n)
    assert committed["postings"] == want < both["postings"]
