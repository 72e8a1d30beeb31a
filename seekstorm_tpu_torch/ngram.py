"""N-gram indexing of frequent terms — phrase-search acceleration.

Re-implements the reference's n-gram subsystem (reference NGRAM_SEARCH.md,
tokenizer.rs:664-830 n-gram composition, index.rs:1834-1851 NgramSet):
consecutive tokens containing frequent words are additionally indexed as
composite bi/tri-gram terms with their own posting lists, so phrase queries
over frequent words hit one short posting list instead of intersecting
multi-million-entry lists.  Phrase queries are rewritten into n-gram
segments at plan time; residual adjacency across segments is verified with
positions as usual.

Bit flags for IndexMeta.ngram_indexing (reference-compatible for the
common values 1, 4, 5):
    1  = FF   (frequent-frequent bigrams)
    2  = FR/RF (mixed bigrams)
    4  = FFF  (frequent trigrams)
    8  = mixed trigrams (RFF / FFR / FRF)

Scoring note: n-gram segments score with the n-gram's own idf and tf
(phrase rarity), not the reference's stored constituent-idf decomposition
(add_result.rs get_bm25f ngram branches) — constituent tfs per n-gram
posting are a later-round layout extension.
"""

from __future__ import annotations

NGRAM_SEP = "\x01"

NGRAM_FF = 1
NGRAM_MIXED2 = 2
NGRAM_FFF = 4
NGRAM_MIXED3 = 8

# standard high-frequency English words (public corpus statistics)
ENGLISH_FREQUENT_WORDS = frozenset(
    """the of and to a in for is on that by this with i you it not or be
    are from at as your all have new more an was we will home can us about
    if page my has search free but our one other do no information time
    they site he up may what which their news out use any there see only
    so his when contact here business who web also now help get pm view
    online first am been would how were me some these its like service
    than find date back top people had list name just over state year day
    into email two health world next used go work last most products music
    buy data make them should product system post her city add policy
    number such please available copyright support message after best
    software then good video well where info rights public books high
    school through each links she review years order very privacy book
    items company read group need many user said does set under general
    research university january mail full map reviews program life know
    games way days management part could great united hotel real item
    international center must store travel comments made development
    report off member details line terms before did send right type
    because local those using results office education national car
    design take posted internet address community within states area want
    phone shipping reserved subject between forum family long based code
    show even black check special prices website index being women much
    sign file link open today technology south case project same pages uk
    version section own found sports house related security both county
    american photo game members power while care network down computer
    systems three total place end following download him without per
    access think north resources current posts big media law control
    water history pictures size art personal since including guide shop
    directory board location change white text small rating rate
    government children during usa return students shopping account times
    sites level digital profile previous form events love old john main
    call hours image department title description non""".split()
)


def frequent_word_set(meta) -> frozenset:
    from .schema import FrequentwordType

    if meta.frequent_words == FrequentwordType.English:
        return ENGLISH_FREQUENT_WORDS
    if meta.frequent_words == FrequentwordType.German:
        from .wordlists import GERMAN_FUNCTION_WORDS

        return GERMAN_FUNCTION_WORDS
    if meta.frequent_words == FrequentwordType.French:
        from .wordlists import FRENCH_FUNCTION_WORDS

        return FRENCH_FUNCTION_WORDS
    if meta.frequent_words == FrequentwordType.Spanish:
        from .wordlists import SPANISH_FUNCTION_WORDS

        return SPANISH_FUNCTION_WORDS
    if meta.frequent_words == FrequentwordType.Custom:
        return frozenset(meta.custom_frequent_words)
    return frozenset()


def ngram_term(tokens: list[str]) -> str:
    return NGRAM_SEP.join(tokens)


def is_ngram_term(term: str) -> bool:
    return NGRAM_SEP in term


def _tri_enabled(flags: int, f: tuple[bool, bool, bool]) -> bool:
    if all(f):
        return bool(flags & NGRAM_FFF)
    # mixed trigrams: RFF / FFR / FRF patterns (at least two frequent)
    return bool(flags & NGRAM_MIXED3) and sum(f) >= 2


def _bi_enabled(flags: int, f: tuple[bool, bool]) -> bool:
    if all(f):
        return bool(flags & NGRAM_FF)
    return bool(flags & NGRAM_MIXED2) and any(f)


def generate_ngrams(
    tokens: list[str], frequent: frozenset, flags: int
) -> dict[str, list[int]]:
    """Token stream -> {ngram term: [positions]} (position = first token's)."""
    out: dict[str, list[int]] = {}
    n = len(tokens)
    freq = [t in frequent for t in tokens]
    for i in range(n - 1):
        if i + 2 < n and _tri_enabled(flags, (freq[i], freq[i + 1], freq[i + 2])):
            out.setdefault(ngram_term(tokens[i : i + 3]), []).append(i)
        if _bi_enabled(flags, (freq[i], freq[i + 1])):
            out.setdefault(ngram_term(tokens[i : i + 2]), []).append(i)
    return out


def segment_phrase(
    tokens: list[str], frequent: frozenset, flags: int
) -> list[tuple[str, int, int]]:
    """Phrase tokens -> [(term, token_offset, token_len)] greedy segments
    using the longest enabled n-gram at each position (reference phrase
    rewrite: NGRAM_SEARCH.md:60-80)."""
    out = []
    freq = [t in frequent for t in tokens]
    i = 0
    n = len(tokens)
    while i < n:
        if i + 3 <= n and _tri_enabled(
            flags, (freq[i], freq[i + 1], freq[i + 2])
        ):
            out.append((ngram_term(tokens[i : i + 3]), i, 3))
            i += 3
        elif i + 2 <= n and _bi_enabled(flags, (freq[i], freq[i + 1])):
            out.append((ngram_term(tokens[i : i + 2]), i, 2))
            i += 2
        else:
            out.append((tokens[i], i, 1))
            i += 1
    return out
