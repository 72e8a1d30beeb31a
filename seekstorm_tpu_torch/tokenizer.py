"""Host-side text analysis: tokenization, folding, stemming, stopwords,
query-operator parsing.

Re-implements the behavior of the reference tokenizer family
(reference seekstorm/src/tokenizer.rs:122-830 — TokenizerType dispatch,
diacritics folding, query operators + - "", stop word removal) with
Python/regex scanning.  This is the slow-but-correct path; a C++ fast path
with the same contract replaces it for bulk ingestion.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field

from .schema import (
    MAX_QUERY_TERMS,
    StemmerType,
    StopwordType,
    TokenizerType,
)

# --------------------------------------------------------------------------
# token scanning

_RE_ASCII_ALPHA = re.compile(r"[A-Za-z]+")
_RE_UNICODE_ALNUM = re.compile(r"[^\W_]+", re.UNICODE)
_RE_WHITESPACE = re.compile(r"\S+")

_LIGATURES = {
    "ß": "ss",
    "æ": "ae",
    "Æ": "AE",
    "œ": "oe",
    "Œ": "OE",
    "ø": "o",
    "Ø": "O",
    "đ": "d",
    "Đ": "D",
    "ð": "d",
    "Ð": "D",
    "þ": "th",
    "Þ": "Th",
    "ł": "l",
    "Ł": "L",
    "ĳ": "ij",
    "Ĳ": "IJ",
    "ﬀ": "ff",
    "ﬁ": "fi",
    "ﬂ": "fl",
    "ﬃ": "ffi",
    "ﬄ": "ffl",
}

_APOSTROPHES = "'’ʼ"


def fold_text(text: str) -> str:
    """Fold diacritics/accents/ligatures (reference tokenizer.rs:27
    fold_diacritics_accents_ligatures_zalgo_umlaut)."""
    out = []
    for ch in text:
        if ch in _LIGATURES:
            out.append(_LIGATURES[ch])
            continue
        decomp = unicodedata.normalize("NFKD", ch)
        kept = [c for c in decomp if not unicodedata.combining(c)]
        out.append("".join(kept) if kept else ch)
    return "".join(out)


def _strip_apostrophes(token: str) -> str:
    return token.translate({ord(c): None for c in _APOSTROPHES})


_CJK_RANGES = (
    (0x2E80, 0x2EFF), (0x3000, 0x303F), (0x3040, 0x30FF), (0x3400, 0x4DBF),
    (0x4E00, 0x9FFF), (0xF900, 0xFAFF), (0x20000, 0x2A6DF),
)


def _is_cjk(cp: int) -> bool:
    return any(a <= cp <= b for a, b in _CJK_RANGES)


def _split_cjk_chars(tokens: list[str], segmenter=None) -> list[str]:
    """CJK segmentation of mixed tokens: continuous CJK runs go through the
    dictionary max-probability segmenter when one is available (reference
    word_segmentation.rs:95 WordSegmentationTM, invoked tokenizer.rs:306);
    without a dictionary each CJK char is its own token (the reference's
    behavior for dictionary misses)."""
    out: list[str] = []
    for tok in tokens:
        cur = ""
        run = ""

        def flush_run():
            nonlocal run
            if run:
                if segmenter is not None:
                    out.extend(segmenter.segment(run))
                else:
                    out.extend(run)
                run = ""

        for ch in tok:
            if _is_cjk(ord(ch)):
                if cur:
                    out.append(cur)
                    cur = ""
                run += ch
            else:
                flush_run()
                cur += ch
        flush_run()
        if cur:
            out.append(cur)
    return out


def tokenize_text(text: str, ttype: TokenizerType) -> list[str]:
    """Split text into raw tokens according to the tokenizer type."""
    if ttype == TokenizerType.AsciiAlphabetic:
        return [m.group(0).lower() for m in _RE_ASCII_ALPHA.finditer(text)]
    if ttype == TokenizerType.Whitespace:
        return [m.group(0) for m in _RE_WHITESPACE.finditer(text)]
    if ttype == TokenizerType.WhitespaceLowercase:
        return [m.group(0).lower() for m in _RE_WHITESPACE.finditer(text)]
    if ttype == TokenizerType.UnicodeAlphanumericFolded:
        folded = fold_text(text)
        folded = _strip_apostrophes(folded)
        return [m.group(0).lower() for m in _RE_UNICODE_ALNUM.finditer(folded)]
    toks = [m.group(0).lower() for m in _RE_UNICODE_ALNUM.finditer(text)]
    if ttype == TokenizerType.UnicodeAlphanumericZH:
        from .word_segmentation import get_segmenter

        toks = _split_cjk_chars(toks, get_segmenter())
    return toks


# --------------------------------------------------------------------------
# stopwords (standard Lucene English stop list)

ENGLISH_STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


def stopword_set(kind: StopwordType, custom: tuple = ()) -> frozenset:
    if kind == StopwordType.English:
        return ENGLISH_STOPWORDS
    if kind == StopwordType.German:
        from .wordlists import GERMAN_FUNCTION_WORDS

        return GERMAN_FUNCTION_WORDS
    if kind == StopwordType.French:
        from .wordlists import FRENCH_FUNCTION_WORDS

        return FRENCH_FUNCTION_WORDS
    if kind == StopwordType.Spanish:
        from .wordlists import SPANISH_FUNCTION_WORDS

        return SPANISH_FUNCTION_WORDS
    if kind == StopwordType.Custom:
        return frozenset(custom)
    return frozenset()


# --------------------------------------------------------------------------
# Porter stemmer (classic public-domain algorithm, Porter 1980)

_VOWELS = "aeiou"


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(stem: str) -> int:
    m, prev_vowel = 0, False
    for i in range(len(stem)):
        v = not _is_cons(stem, i)
        if not v and prev_vowel:
            m += 1
        prev_vowel = v
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    if len(w) < 3:
        return False
    if (
        _is_cons(w, len(w) - 3)
        and not _is_cons(w, len(w) - 2)
        and _is_cons(w, len(w) - 1)
    ):
        return w[-1] not in "wxy"
    return False


_STEP2 = [
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
    ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
    ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
    ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
    ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
]
_STEP3 = [
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""),
]
_STEP4 = [
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment",
    "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
]


def porter_stem(w: str) -> str:
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w, flag = w[:-2], True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w, flag = w[:-3], True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in _STEP2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    for suf, rep in _STEP3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    for suf in _STEP4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if suf == "ion" and not stem.endswith(("s", "t")):
                break
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and _measure(w[:-3]) > 1 and w[:-3].endswith(("s", "t")):
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


def stem_token(token: str, stemmer: StemmerType) -> str:
    if stemmer in (StemmerType.English, StemmerType.Porter):
        return porter_stem(token)
    from .stemmers import get_stem_fn

    fn = get_stem_fn(stemmer)
    return fn(token) if fn is not None else token


# --------------------------------------------------------------------------
# analysis pipeline

class Analyzer:
    """Bundles tokenizer + stemmer + stopwords for one index."""

    def __init__(
        self,
        tokenizer: TokenizerType,
        stemmer: StemmerType = StemmerType.Null,
        stopwords: StopwordType = StopwordType.Null,
        custom_stopwords: tuple = (),
    ):
        self.tokenizer = tokenizer
        self.stemmer = stemmer
        self.stopwords = stopword_set(stopwords, custom_stopwords)
        if stemmer == StemmerType.Null:
            self._stem_fn = None
        else:
            from .stemmers import get_stem_fn

            self._stem_fn = get_stem_fn(stemmer)

    def analyze(self, text: str) -> list[str]:
        """Field text -> final token stream (stopwords removed, stemmed).

        Positions are indices in the post-stopword stream, matching the
        reference which removes stopwords before position assignment.
        """
        toks = tokenize_text(text, self.tokenizer)
        if self.stopwords:
            toks = [t for t in toks if t not in self.stopwords]
        if self._stem_fn is not None:
            fn = self._stem_fn
            toks = [fn(t) for t in toks]
        return toks

    def term_positions(self, text: str) -> dict[str, list[int]]:
        """Field text -> {term: [positions]} capped at u16 positions."""
        out: dict[str, list[int]] = {}
        for pos, tok in enumerate(self.analyze(text)):
            if pos >= 65_535:
                break
            out.setdefault(tok, []).append(pos)
        return out


# --------------------------------------------------------------------------
# query parsing (operators + - "", reference tokenizer.rs:664+)

@dataclass
class QueryTerm:
    term: str
    required: bool = False   # '+' prefix (or Intersection default)
    negated: bool = False    # '-' prefix
    phrase_id: int = -1      # >= 0 when part of a quoted phrase
    phrase_pos: int = 0      # position inside the phrase


@dataclass
class ParsedQuery:
    terms: list[QueryTerm] = field(default_factory=list)
    phrases: list[list[int]] = field(default_factory=list)  # term indices per phrase


_RE_QUERY_PART = re.compile(r'([+-]?)"([^"]*)"|([+-]?)(\S+)')


_PARSE_CACHE_MAX = 65_536


def parse_query(query: str, analyzer: Analyzer) -> ParsedQuery:
    """Parse query operators then analyze each part (bounded cache per
    analyzer: query streams are zipfian, so repeated strings dominate
    serving and the parse is pure given the analyzer config; the result
    is treated as immutable by all consumers).

    Semantics (reference tokenizer.rs query-operator parsing): '+term' makes
    the term required, '-term' negates it, '"a b"' requires the exact phrase.
    Remaining terms follow the request's default query type.
    """
    cache = getattr(analyzer, "_parse_cache", None)
    if cache is None:
        cache = analyzer._parse_cache = {}
    hit = cache.get(query)
    if hit is not None:
        return hit
    pq = _parse_query_uncached(query, analyzer)
    if len(cache) >= _PARSE_CACHE_MAX:
        cache.clear()
    cache[query] = pq
    return pq


def _parse_query_uncached(query: str, analyzer: Analyzer) -> ParsedQuery:
    pq = ParsedQuery()
    for m in _RE_QUERY_PART.finditer(query):
        if m.group(2) is not None:  # quoted phrase
            op = m.group(1)
            toks = analyzer.analyze(m.group(2))
            if not toks:
                continue
            if len(toks) == 1:
                pq.terms.append(QueryTerm(toks[0], required=True, negated=op == "-"))
                continue
            pid = len(pq.phrases)
            idxs = []
            for i, t in enumerate(toks):
                idxs.append(len(pq.terms))
                pq.terms.append(
                    QueryTerm(t, required=True, negated=op == "-",
                              phrase_id=pid, phrase_pos=i)
                )
            pq.phrases.append(idxs)
        else:
            op = m.group(3)
            toks = analyzer.analyze(m.group(4))
            for t in toks:
                pq.terms.append(
                    QueryTerm(t, required=op == "+", negated=op == "-")
                )
        if len(pq.terms) >= MAX_QUERY_TERMS:
            pq.terms = pq.terms[:MAX_QUERY_TERMS]
            break
    return pq
