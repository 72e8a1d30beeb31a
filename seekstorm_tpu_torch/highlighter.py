"""KWIC highlighter: fragment selection + term markup.

Host-side, mirroring the reference highlighter semantics (reference
seekstorm/src/highlighter.rs:13-382 — Highlight params, fragment selection
top_fragments_from_field, <b> markup).  Round-1 implementation matches on
analyzed tokens; the Aho-Corasick fast path replaces the scanner later.
"""

from __future__ import annotations

import re

from .tokenizer import tokenize_text
from .utils import term_hash


def _query_term_set(index, req) -> set[str]:
    from .tokenizer import parse_query

    pq = parse_query(req.query, index.analyzer)
    terms = {t.term for t in pq.terms if not t.negated}
    # synonym-aware highlighting (reference highlighter.rs:71-103 builds its
    # Aho-Corasick matcher over the synonym-expanded term set): a document
    # indexed under a synonym of a query term matched through that synonym,
    # so the synonym's surface form must highlight too.  _synonym_map maps
    # doc-term -> indexed-under synonyms, so expand query terms with every
    # doc-term whose synonym set intersects them.
    syn = getattr(index, "_synonym_map", None)
    if syn and terms:
        terms |= {w for w, ss in syn.items() if ss & terms}
    return terms


def highlight_field(
    index, text: str, terms: set[str], fragment_number: int,
    fragment_size: int, markup: bool,
) -> list[str]:
    """Select the best fragments of `text` containing query terms."""
    if not text or not terms:
        return []
    # locate term occurrences (char spans): one regex pass + cheap per-word
    # normalization (the per-word analyzer round trip cost ~16 µs/token —
    # 5 ms per KB of text; this single-pass scan is the Python analog of
    # the reference's Aho-Corasick scan, highlighter.rs:137)
    from .schema import StemmerType
    from .tokenizer import stem_token

    an = index.analyzer
    stem = an.stemmer if an.stemmer != StemmerType.Null else None
    spans = []
    for m in re.finditer(r"\w+", text, re.UNICODE):
        w = m.group(0).lower()
        if w in terms:
            spans.append((m.start(), m.end()))
            continue
        if stem is not None and stem_token(w, stem) in terms:
            spans.append((m.start(), m.end()))
    if not spans:
        # fall back to the leading fragment
        return [text[:fragment_size]] if fragment_number else []

    fragments: list[str] = []
    used: set[int] = set()
    for _ in range(max(fragment_number, 1)):
        # greedy: window with most uncovered term hits
        best, best_hits = None, 0
        for s, _e in spans:
            if s in used:
                continue
            w_start = max(0, s - fragment_size // 4)
            w_end = min(len(text), w_start + fragment_size)
            hits = sum(1 for a, b in spans if w_start <= a and b <= w_end)
            if hits > best_hits:
                best, best_hits = (w_start, w_end), hits
        if best is None:
            break
        w_start, w_end = best
        for a, b in spans:
            if w_start <= a and b <= w_end:
                used.add(a)
        frag = text[w_start:w_end]
        if markup:
            out, last = [], 0
            for a, b in spans:
                if w_start <= a and b <= w_end:
                    out.append(frag[last : a - w_start])
                    out.append("<b>")
                    out.append(frag[a - w_start : b - w_start])
                    out.append("</b>")
                    last = b - w_start
            out.append(frag[last:])
            frag = "".join(out)
        fragments.append(frag)
        if len(fragments) >= fragment_number:
            break
    return fragments


def highlight_doc(index, req, doc: dict) -> dict:
    terms = _query_term_set(index, req)
    out = dict(doc)
    highlights = {}
    for h in req.highlights:
        text = doc.get(h.field)
        if not isinstance(text, str):
            continue
        frags = highlight_field(
            index, text, terms, h.fragment_number, h.fragment_size,
            h.highlight_markup,
        )
        highlights[h.field] = " … ".join(frags)
    if highlights:
        out["_highlights"] = highlights
    return out
