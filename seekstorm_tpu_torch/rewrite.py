"""Query rewriting: SymSpell spelling correction + pruning-radix-trie query
auto-completion.

Host-CPU structures mirroring the reference's wired-in dependency
(reference Cargo.toml symspell_complete_rs; fed at commit.rs:418-443,
sampled at index_posting.rs:25-49, queried in the QAC/spell rewrite loop
search.rs:1200-1390; persisted as dictionary.csv / completions.csv,
index.rs:96-97).  SymSpell (delete-variant hashing + Damerau-Levenshtein)
and the top-k-pruned radix trie are classic public algorithms.
"""

from __future__ import annotations

import csv
import io
from dataclasses import dataclass
from pathlib import Path


def damerau_levenshtein(a: str, b: str, cap: int = 10) -> int:
    """Optimal-string-alignment Damerau-Levenshtein distance."""
    la, lb = len(a), len(b)
    if abs(la - lb) > cap:
        return cap + 1
    prev2 = None
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (
                i > 1 and j > 1
                and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]
            ):
                cur[j] = min(cur[j], prev2[j - 2] + 1)
        prev2, prev = prev, cur
    return prev[lb]


class SymSpell:
    """Delete-variant spelling dictionary (Garbe's SymSpell algorithm)."""

    def __init__(self, max_edit: int = 2, prefix_len: int = 7,
                 count_threshold: int = 1, max_entries: int = 1_000_000):
        self.max_edit = max_edit
        self.prefix_len = prefix_len
        self.count_threshold = count_threshold
        self.max_entries = max_entries
        self.words: dict[str, int] = {}
        self._deletes: dict[str, list[str]] = {}
        self._indexed: set[str] = set()

    def __len__(self) -> int:
        return len(self.words)

    def add(self, word: str, count: int = 1) -> None:
        c = self.words.get(word, 0) + count
        self.words[word] = c
        if (
            c >= self.count_threshold
            and word not in self._indexed
            and len(self._indexed) < self.max_entries
        ):
            self._indexed.add(word)
            for d in self._edits(word[: self.prefix_len], self.max_edit):
                self._deletes.setdefault(d, []).append(word)

    def _edits(self, word: str, depth: int) -> set[str]:
        out = {word}
        frontier = {word}
        for _ in range(depth):
            nxt = set()
            for w in frontier:
                for i in range(len(w)):
                    nxt.add(w[:i] + w[i + 1 :])
            nxt -= out
            out |= nxt
            frontier = nxt
        return out

    def lookup(self, term: str, max_edit: int | None = None,
               length: int = 5) -> list[tuple[str, int, int]]:
        """-> [(word, distance, count)] best-first."""
        me = min(max_edit if max_edit is not None else self.max_edit,
                 self.max_edit)
        if term in self.words and self.words[term] >= self.count_threshold:
            return [(term, 0, self.words[term])]
        cands: set[str] = set()
        for d in self._edits(term[: self.prefix_len], me):
            for w in self._deletes.get(d, ()):
                cands.add(w)
        out = []
        for w in cands:
            dist = damerau_levenshtein(term, w, me)
            if dist <= me:
                out.append((w, dist, self.words.get(w, 0)))
        out.sort(key=lambda x: (x[1], -x[2], x[0]))
        return out[:length]

    def _known(self, w: str) -> bool:
        return self.words.get(w, 0) >= self.count_threshold

    def _token_best(self, t: str, me: int):
        """Best single-token resolution: direct correction OR a split into
        two dictionary words -> (distance, -count, replacement) or None.

        Split distance is 1 (the inserted space) and its count proxy is
        the rarer part's count — SymSpell's naive-Bayes product ranks
        identically under a fixed corpus size for the tie cases here."""
        cands = []
        b = self.lookup(t, me, length=1)
        if b:
            cands.append((b[0][1], -b[0][2], b[0][0]))
        if len(t) >= 4:
            for p in range(2, len(t) - 1):
                a, c = t[:p], t[p:]
                if self._known(a) and self._known(c):
                    cands.append(
                        (1, -min(self.words[a], self.words[c]),
                         a + " " + c))
        return min(cands) if cands else None

    def lookup_compound(self, terms: list[str], max_edit: int | None = None,
                        min_len: int = 2) -> tuple[list[str], bool]:
        """Compound-aware correction of a term list (reference
        lookup_compound_vec, wired at search.rs:1324-1363): each unknown
        term tries (a) a direct correction, (b) a SPLIT at every position
        into two dictionary words ("newyork" -> "new york"), and (c) a
        MERGE with the following unknown term ("qui ckbrown" ->
        "quickbrown" -> resolved again, so a merged pair can re-split
        into the right words).  Candidates rank by (edit distance,
        frequency); merges count the removed space as one edit.
        Returns (terms, changed)."""
        me = min(max_edit if max_edit is not None else self.max_edit,
                 self.max_edit)
        out: list[str] = []
        changed = False
        i = 0
        while i < len(terms):
            t = terms[i]
            if len(t) < min_len or self._known(t):
                out.append(t)
                i += 1
                continue
            best = self._token_best(t, me)
            if i + 1 < len(terms):
                nxt = terms[i + 1]
                if len(nxt) >= 1 and not self._known(nxt):
                    mb = self._token_best(t + nxt, me)
                    if mb is not None:
                        merged = (mb[0] + 1, mb[1], mb[2])
                        if best is None or merged < best:
                            out.extend(merged[2].split(" "))
                            i += 2
                            changed = True
                            continue
            if best is not None and best[2] != t and best[0] > 0:
                out.extend(best[2].split(" "))
                changed = True
            else:
                out.append(t)
            i += 1
        return out, changed

    # -- persistence (dictionary.csv, reference index.rs:96) -------------
    def save(self, path: Path) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            for word, count in sorted(self.words.items()):
                w.writerow([word, count])

    @classmethod
    def load(cls, path: Path, **kwargs) -> "SymSpell":
        s = cls(**kwargs)
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    s.add(row[0], int(row[1]))
        return s


class _RNode:
    """Radix-trie node: children keyed by the edge label's first char,
    storing (full edge label, child)."""

    __slots__ = ("children", "weight", "max_weight")

    def __init__(self):
        self.children: dict[str, tuple[str, "_RNode"]] = {}
        self.weight = 0       # weight of a complete term ending here
        self.max_weight = 0   # max weight in subtree (pruning bound)


class PruningRadixTrie:
    """Top-k-pruned PATH-COMPRESSED trie (Garbe's PruningRadixTrie): edges
    carry whole substrings, so node count tracks the number of terms (at
    most 2n-1 nodes) instead of total characters — the reference depends
    on the PruningRadixTrie crate for the same reason (index.rs:1745).
    Each node stores the max weight in its subtree; top-k prefix lookups
    run an ITERATIVE best-first expansion (max_weight-ordered heap) that
    terminates as soon as the k-th collected weight beats the best
    unexpanded subtree — sub-ms at 1M+ completions, no recursion limits."""

    def __init__(self, max_entries: int = 1_000_000):
        self.root = _RNode()
        self.size = 0
        self.node_count = 1
        self.max_entries = max_entries
        self._terms: dict[str, int] = {}

    def __len__(self) -> int:
        return self.size

    def add(self, term: str, weight: int = 1) -> None:
        if not term:
            return
        if term not in self._terms and self.size >= self.max_entries:
            return
        new_w = self._terms.get(term, 0) + weight
        self._terms[term] = new_w
        if new_w == weight:
            self.size += 1
        node = self.root
        node.max_weight = max(node.max_weight, new_w)
        pos = 0
        while pos < len(term):
            ent = node.children.get(term[pos])
            if ent is None:
                child = _RNode()
                child.max_weight = new_w
                node.children[term[pos]] = (term[pos:], child)
                self.node_count += 1
                node = child
                pos = len(term)
                break
            label, child = ent
            rest = term[pos:]
            m = 0
            lim = min(len(label), len(rest))
            while m < lim and label[m] == rest[m]:
                m += 1
            if m == len(label):
                child.max_weight = max(child.max_weight, new_w)
                node = child
                pos += m
            else:
                # split the edge at the divergence point
                mid = _RNode()
                mid.max_weight = max(child.max_weight, new_w)
                mid.children[label[m]] = (label[m:], child)
                node.children[term[pos]] = (label[:m], mid)
                self.node_count += 1
                node = mid
                pos += m
        node.weight = new_w

    def top_k(self, prefix: str, k: int = 5) -> list[tuple[str, int]]:
        import heapq

        # descend the prefix (it may end mid-edge)
        node = self.root
        acc = ""
        pos = 0
        while pos < len(prefix):
            ent = node.children.get(prefix[pos])
            if ent is None:
                return []
            label, child = ent
            rest = prefix[pos:]
            lim = min(len(label), len(rest))
            if label[:lim] != rest[:lim]:
                return []
            acc += label
            pos += len(label)
            node = child

        # best-first expansion ordered by subtree max_weight: exact top-k
        # with the minimum number of node visits
        results: list[tuple[int, str]] = []   # min-heap by weight
        tie = 0
        frontier = [(-node.max_weight, tie, acc, node)]
        while frontier:
            neg_mw, _, s, n = heapq.heappop(frontier)
            if len(results) >= k and -neg_mw <= results[0][0]:
                break  # no unexpanded subtree can beat the k-th best
            if n.weight:
                if len(results) < k:
                    heapq.heappush(results, (n.weight, s))
                elif n.weight > results[0][0]:
                    heapq.heapreplace(results, (n.weight, s))
            for label, child in n.children.values():
                tie += 1
                heapq.heappush(
                    frontier, (-child.max_weight, tie, s + label, child))
        return [(t, w) for w, t in sorted(results, key=lambda x: -x[0])]

    # -- persistence (completions.csv, reference index.rs:97) ------------
    def save(self, path: Path) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            for term, weight in sorted(self._terms.items()):
                w.writerow([term, weight])

    @classmethod
    def load(cls, path: Path, **kwargs) -> "PruningRadixTrie":
        t = cls(**kwargs)
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    t.add(row[0], int(row[1]))
        return t


# ---------------------------------------------------------------------------
# query rewriting dispatch (reference search.rs:1200-1390 QAC/spell loop)

@dataclass
class RewriteOutcome:
    query: str               # query actually searched
    suggestions: list[str]   # corrected/completed suggestions
    rewritten: bool


def _complete_multiterm(index, trie, query: str, length: int) -> list[str]:
    """Query completion with the reference's windowing + continuation
    heuristics (search.rs:1152-1314):

    * lookup window = the last <=3 query terms (the trie stores 1..3-gram
      phrases); an intact earlier prefix is re-prepended to every
      suggestion.  A trailing space shifts the window (the user finished
      the last term — complete the NEXT one).
    * continuation: when the window lookup can't fill the page and the
      query has >=2 terms, the first >=3-word completion's tail seeds a
      second lookup whose results (skipping frequent-word endings) are
      spliced in right after it, under a 1-2 term shorter prefix.
    """
    terms = query.lower().split()
    if not terms:
        return []
    sufflen = 1 if query.endswith(" ") else 0
    if len(terms) + sufflen > 3:
        cut = len(terms) - 3 + sufflen
        prefix = " ".join(terms[:cut]) + " "
        window = " ".join(terms[cut:]) + (" " if sufflen else "")
    else:
        prefix = ""
        window = " ".join(terms) + (" " if sufflen else "")
    comp = trie.top_k(window, length)
    out = [prefix + t for t, _ in comp]

    if comp and len(out) < length and len(terms) >= 2:
        position = 0
        tail_vec: list[str] = []
        for i, (t, _) in enumerate(comp):
            tv = t.split(" ")
            if len(tv) >= 3:
                position = i + 1
                tail_vec = tv
                break
        if len(tail_vec) >= 3:
            cont = " ".join(tail_vec[1:]) + " "
            additional = trie.top_k(cont, length - len(out) + 5)
            drop = 1 if len(terms) == 2 else 2
            prefix2 = " ".join(terms[: len(terms) - drop])
            prefix2 = prefix2 + " " if prefix2 else ""
            frequent = getattr(index, "_frequent_words", set()) or set()
            seen = set(out)
            j = 0
            for t, _ in additional:
                if " " in t and t.rsplit(" ", 1)[1] in frequent:
                    continue
                cand = prefix2 + t
                if cand in seen:
                    continue  # window lookup already produced it
                seen.add(cand)
                out.insert(position + j, cand)
                j += 1
                if len(out) >= length:
                    break
    return out[:length]


def rewrite_query(
    index, query: str, mode, analyzer
) -> RewriteOutcome:
    """mode: 'SearchOnly' or {'SearchSuggest'|'SearchRewrite'|'SuggestOnly':
    {correct, distance, complete, length, ...}}."""
    if mode in (None, "SearchOnly"):
        return RewriteOutcome(query, [], False)
    if isinstance(mode, str):
        name, params = mode, {}
    else:
        name = next(iter(mode))
        params = mode[name] or {}
    correct_thr = params.get("correct")
    complete_thr = params.get("complete")
    distance = params.get("distance", 2)
    length = params.get("length") or 5

    suggestions: list[str] = []
    corrected = query
    # completion: the trie holds 1..3-gram phrases, so the lookup window
    # is the LAST <=3 terms; earlier terms are re-prepended verbatim, and
    # a multi-term continuation fills the page when the window alone can't
    # (reference search.rs:1254-1314)
    trie = getattr(index, "completions", None)
    if trie is not None and complete_thr is not None and \
            len(query) >= complete_thr:
        suggestions.extend(_complete_multiterm(index, trie, query, length))
    # spelling correction term-wise
    spell = getattr(index, "spell", None)
    if spell is not None and correct_thr is not None and \
            len(query) >= correct_thr:
        terms = analyzer.analyze(query)
        fixed, changed = spell.lookup_compound(terms, distance)
        if changed:
            corrected = " ".join(fixed)
            if corrected not in suggestions:
                suggestions.append(corrected)

    if name == "SuggestOnly":
        return RewriteOutcome(query, suggestions[:length], False)
    if name == "SearchRewrite":
        new_q = suggestions[0] if suggestions else query
        return RewriteOutcome(new_q, suggestions[:length], new_q != query)
    # SearchSuggest: search original, attach suggestions
    return RewriteOutcome(query, suggestions[:length], False)
