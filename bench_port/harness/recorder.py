"""What the window served, kept for the check, and the check's numbers
beside their limits: shared by every deployment kind."""

from __future__ import annotations

from collections import Counter

import numpy as np


def answer_key(rs) -> tuple:
    """A served answer as the check compares it: (ids, scores, count)."""
    return (tuple(r.doc_id for r in rs.results),
            tuple(r.score for r in rs.results), rs.result_count_total)


def limits_check(numbers: dict, limits: dict) -> dict:
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


class Recorder:
    """Served answers by pool index: a Counter of ``key(result set)`` (a
    kind's answer key, ``answer_key`` unless it keeps more) for the sampled
    entries (every entry with ``keep_all``), and how many times each pool
    entry was served."""

    def __init__(self, sample: np.ndarray, keep_all: bool, key=answer_key):
        self.sample = sample
        self._in_sample = np.zeros(int(sample.max()) + 1 if len(sample)
                                   else 0, bool)
        self._in_sample[sample] = True
        self.keep_all = keep_all
        self.key = key
        self.answers: dict[int, Counter] = {}
        self.all_answers: dict[int, Counter] = {}

    def wants(self, pi: int) -> bool:
        return self.keep_all or (pi < len(self._in_sample)
                                 and self._in_sample[pi])

    def add(self, pi: int, rs) -> None:
        key = self.key(rs)
        if pi < len(self._in_sample) and self._in_sample[pi]:
            self.answers.setdefault(pi, Counter())[key] += 1
        if self.keep_all:
            self.all_answers.setdefault(pi, Counter())[key] += 1

    def merge(self, other: "Recorder") -> None:
        for mine, theirs in ((self.answers, other.answers),
                             (self.all_answers, other.all_answers)):
            for pi, c in theirs.items():
                mine.setdefault(pi, Counter()).update(c)
