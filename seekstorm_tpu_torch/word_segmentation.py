"""Chinese word segmentation: maximum-probability (unigram Viterbi) DP.

The reference segments continuous CJK runs with WordSegmentationTM — a
triangular-matrix dynamic program maximizing the sum of logarithmic word
frequencies over a 349K-entry zh_CN frequency dictionary (reference
seekstorm/src/word_segmentation.rs:95-190, invoked from tokenizer.rs:306,
458 for the UnicodeAlphanumericZH tokenizer). This module implements the
same objective as a plain prefix DP:

    best(i) = max over words w ending at i of best(i - len(w)) + log10 P(w)

with SymSpell's naive estimate for unknown character runs,
log10(10 / (N * 10^len)) — long unknown runs are exponentially penalized,
so known words win and leftovers split into single characters.

The dictionary is DATA, loaded at runtime (word<TAB|SPACE>count per line):
  1. `SEEKSTORM_TPU_ZH_DICT` (path), or
  2. `<index>/zh_dict.txt`, or
  3. a small built-in seed lexicon (demo/tests; real deployments should
     install a full frequency dictionary, e.g. one derived from the public
     jieba/SymSpell zh_CN corpora).
Without any dictionary the tokenizer keeps the character-level fallback,
which the reference also applies to dictionary-miss runs.
"""

from __future__ import annotations

import math
import os
from pathlib import Path

# Seed lexicon (word, relative count) — a tiny set of very common Mandarin
# words so segmentation works out of the box; counts are rough Zipf-like
# weights, not corpus-exact.
_SEED = [
    ("的", 800000), ("是", 400000), ("了", 350000), ("在", 300000),
    ("我", 280000), ("有", 260000), ("他", 240000), ("这", 220000),
    ("中", 200000), ("大", 190000), ("来", 180000), ("上", 175000),
    ("国", 170000), ("个", 165000), ("到", 160000), ("说", 155000),
    ("们", 150000), ("为", 145000), ("子", 140000), ("和", 135000),
    ("你", 130000), ("地", 125000), ("出", 120000), ("道", 115000),
    ("也", 110000), ("时", 105000), ("年", 100000), ("得", 98000),
    ("就", 96000), ("那", 94000), ("要", 92000), ("下", 90000),
    ("以", 88000), ("生", 86000), ("会", 84000), ("自", 82000),
    ("着", 80000), ("去", 78000), ("之", 76000), ("过", 74000),
    ("家", 72000), ("学", 70000), ("对", 68000), ("可", 66000),
    ("她", 64000), ("里", 62000), ("后", 60000), ("小", 58000),
    ("么", 56000), ("心", 54000), ("多", 52000), ("天", 50000),
    ("而", 48000), ("能", 46000), ("好", 44000), ("都", 42000),
    ("然", 40000), ("没", 38000), ("日", 36000), ("于", 34000),
    ("起", 32000), ("还", 30000), ("发", 29000), ("成", 28000),
    ("事", 27000), ("只", 26000), ("作", 25000), ("当", 24000),
    ("想", 23000), ("看", 22000), ("文", 21000), ("无", 20000),
    ("开", 19500), ("手", 19000), ("十", 18500), ("用", 18000),
    ("主", 17500), ("行", 17000), ("方", 16500), ("又", 16000),
    ("如", 15500), ("前", 15000), ("所", 14500), ("本", 14000),
    ("见", 13500), ("经", 13000), ("头", 12500), ("面", 12000),
    ("公", 11500), ("同", 11000), ("三", 10500), ("已", 10000),
    # common multi-character words
    ("中国", 90000), ("我们", 85000), ("他们", 60000), ("自己", 55000),
    ("没有", 52000), ("可以", 50000), ("这个", 45000), ("什么", 44000),
    ("一个", 43000), ("现在", 40000), ("知道", 38000), ("时候", 36000),
    ("因为", 34000), ("所以", 32000), ("但是", 31000), ("已经", 30000),
    ("还是", 29000), ("大家", 28000), ("工作", 27000), ("学习", 26000),
    ("生活", 25000), ("世界", 24000), ("时间", 23000), ("问题", 22000),
    ("今天", 21000), ("非常", 20000), ("很多", 19000), ("事情", 18000),
    ("国家", 17000), ("地方", 16000), ("学校", 15000), ("学生", 14500),
    ("老师", 14000), ("朋友", 13500), ("公司", 13000), ("经济", 12500),
    ("社会", 12000), ("发展", 11500), ("技术", 11000), ("搜索", 10500),
    ("引擎", 10200), ("搜索引擎", 9000), ("北京", 9500), ("上海", 9200),
    ("喜欢", 8800), ("电脑", 8600), ("手机", 8400), ("互联网", 8200),
    ("数据", 8000), ("系统", 7800), ("程序", 7600), ("软件", 7400),
]


class WordSegmenter:
    """Unigram max-probability segmenter (reference WordSegmentationTM
    semantics; plain prefix DP instead of the circular-buffer matrix)."""

    def __init__(self):
        self.logp: dict[str, float] = {}
        self.max_len = 1
        self.n = 0.0

    def load_pairs(self, pairs) -> None:
        counts = {}
        total = 0.0
        for w, c in pairs:
            counts[w] = counts.get(w, 0.0) + float(c)
            total += float(c)
        self.n = max(total, 1.0)
        for w, c in counts.items():
            self.logp[w] = math.log10(c / self.n)
            self.max_len = max(self.max_len, len(w))

    def load_file(self, path, term_index: int = 0, count_index: int = 1,
                  skip_ascii: bool = True) -> bool:
        p = Path(path)
        if not p.exists():
            return False
        pairs = []
        with open(p, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) <= max(term_index, count_index):
                    continue
                w = parts[term_index]
                if skip_ascii and w.isascii():
                    continue
                try:
                    pairs.append((w, int(parts[count_index])))
                except ValueError:
                    continue
        if pairs:
            self.load_pairs(pairs)
        return bool(pairs)

    def _unknown_logp(self, length: int) -> float:
        # SymSpell naive estimate: log10(10 / (N * 10^len))
        return math.log10(10.0 / (self.n * (10.0 ** length)))

    def segment(self, text: str) -> list[str]:
        """Best segmentation of a continuous (CJK) run."""
        n = len(text)
        if n == 0:
            return []
        if not self.logp:
            return list(text)
        NEG = -1e30
        best = [NEG] * (n + 1)
        back = [0] * (n + 1)
        best[0] = 0.0
        for i in range(1, n + 1):
            lo = max(0, i - self.max_len)
            for j in range(lo, i):
                w = text[j:i]
                lp = self.logp.get(w)
                if lp is None:
                    if i - j > 1:
                        continue
                    lp = self._unknown_logp(1)
                cand = best[j] + lp
                if cand > best[i]:
                    best[i] = cand
                    back[i] = j
        out = []
        i = n
        while i > 0:
            j = back[i]
            out.append(text[j:i])
            i = j
        out.reverse()
        return out


_CACHED: dict[str, WordSegmenter | None] = {}


def full_dictionary_path() -> Path | None:
    """Path of the full 349K-entry zh_CN frequency dictionary, if present.

    The jieba package (MIT, baked into this environment) ships dict.txt —
    the same public frequency list the reference's embedded
    frequency_dictionary_zh_cn_349_045.txt asset derives from (reference
    word_segmentation.rs:9-10)."""
    try:
        import jieba

        p = Path(jieba.__file__).parent / "dict.txt"
        return p if p.exists() else None
    except ImportError:
        return None


def resolve_dict_path(index_path=None) -> Path | None:
    """The dictionary FILE an index resolves, in priority order:
    env `SEEKSTORM_TPU_ZH_DICT` > `<index>/zh_dict.txt` > full public
    zh_CN list.  The native (C++) tokenizer loads the same file so ingest
    and query tokenization agree byte-for-byte."""
    env = os.environ.get("SEEKSTORM_TPU_ZH_DICT")
    if env and Path(env).exists():
        return Path(env)
    if index_path is not None:
        p = Path(index_path) / "zh_dict.txt"
        if p.exists():
            return p
    return full_dictionary_path()


def get_segmenter(index_path=None) -> WordSegmenter:
    """Segmenter for an index: env dict > index-local dict > full public
    zh_CN frequency dictionary (349K entries) > seed lexicon."""
    key = str(index_path or "")
    hit = _CACHED.get(key)
    if hit is not None:
        return hit
    seg = WordSegmenter()
    p = resolve_dict_path(index_path)
    loaded = p is not None and seg.load_file(p)
    if not loaded:
        seg.load_pairs(_SEED)
    _CACHED[key] = seg
    return seg
