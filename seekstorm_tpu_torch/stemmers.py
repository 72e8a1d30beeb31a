"""Multi-language stemming (reference seekstorm/src/index.rs:642-721
StemmerType — 38 languages via the snowball_stemmers_rs crate, applied in
tokenizer.rs:576-589).

Three implementation tiers, chosen per language:

* **Native Snowball (C++)** — native/snowball.cpp ports of the published
  Snowball algorithms for Arabic, Danish, Dutch (+DutchPorter alias),
  Finnish, French, German, Hungarian, Italian, Norwegian, Portuguese,
  Romanian, Russian, Spanish, Swedish — byte-exact against NLTK's
  Snowball implementations (validated per language in
  tests/test_stemmers.py and on 4K-word random fuzz vectors), applied
  both by the C++ ingest fast path and, via ctypes, by the Python
  analyzer, so every path emits identical tokens.
* **Exact Snowball via NLTK** — pure-Python fallback for the same
  languages when the native library isn't built.
* **Light rule-based stemmers** — the remaining languages, implemented here
  as published light-stemmer rule sets (suffix/prefix stripping with
  minimum-stem guards): the CLEF light-stemmer family (Savoy; Dolamic &
  Savoy for Czech/Russian-family), Ramanathan & Rao for Hindi, Tala's
  Porter-style stemmer for Indonesian, and compact rule sets for the
  remainder.  These are deliberately conservative (recall-oriented,
  merge-inflections) rather than byte-exact Snowball ports.  Each one
  ALSO has a C++ port (native/light_stemmers.cpp; rule tables GENERATED
  from this module by gen_light_tables.py, fuzz-verified byte-identical)
  so every language rides the native ingest fast path.

`StemmerType.English` keeps the in-repo Porter implementation
(tokenizer.porter_stem / native C++ porter_stem) so the Python and native
ingest paths stay byte-identical; `Porter` maps to the same algorithm.

All stemmers here are host-side CPU text processing (SURVEY §7: tokenizer
family stays on the host); light-tier languages run the Python ingest
path (index.py gates the C++ fast path on native stemmer support).
"""

from __future__ import annotations

from .schema import StemmerType

# ---------------------------------------------------------------------------
# tier 1: exact Snowball via NLTK (lazy singletons; import cost once)

_NLTK_LANG = {
    StemmerType.Arabic: "arabic",
    StemmerType.Danish: "danish",
    StemmerType.Dutch: "dutch",
    StemmerType.DutchPorter: "dutch",
    StemmerType.Finnish: "finnish",
    StemmerType.French: "french",
    StemmerType.German: "german",
    StemmerType.Hungarian: "hungarian",
    StemmerType.Italian: "italian",
    StemmerType.Norwegian: "norwegian",
    StemmerType.Portuguese: "portuguese",
    StemmerType.Romanian: "romanian",
    StemmerType.Russian: "russian",
    StemmerType.Spanish: "spanish",
    StemmerType.Swedish: "swedish",
}

_nltk_cache: dict = {}


def _nltk_stem_fn(lang: str):
    fn = _nltk_cache.get(lang)
    if fn is None:
        from nltk.stem.snowball import SnowballStemmer

        st = SnowballStemmer(lang)
        fn = st.stem
        _nltk_cache[lang] = fn
    return fn


# ---------------------------------------------------------------------------
# tier 2: light rule-based stemmers
#
# Shared helper: strip the longest matching suffix from an ordered list,
# keeping at least `min_stem` characters.


def _strip_longest(word: str, suffixes, min_stem: int = 3) -> str:
    for suf in suffixes:
        if word.endswith(suf) and len(word) - len(suf) >= min_stem:
            return word[: -len(suf)]
    return word


def _strip_iter(word: str, suffixes, min_stem: int = 3, rounds: int = 3) -> str:
    for _ in range(rounds):
        nw = _strip_longest(word, suffixes, min_stem)
        if nw == word:
            break
        word = nw
    return word


# --- Esperanto: fully regular grammar — strip grammatical endings ----------
_EO_SUF = ("ojn", "ajn", "oj", "aj", "on", "an", "en", "as", "is", "os",
           "us", "o", "a", "e", "u", "i", "n")


def _stem_esperanto(w: str) -> str:
    return _strip_longest(w, _EO_SUF, 2)


# --- Czech: Dolamic & Savoy light stemmer (case endings + palatalization) --
_CS_CASE = ("atech", "ětem", "etem", "atům", "ech", "ich", "ích", "ého",
            "ěmi", "emi", "ému", "ete", "eti", "iho", "ího", "ími", "imu",
            "ách", "ata", "aty", "ých", "ama", "ami", "ové", "ovi", "ými",
            "em", "es", "ém", "ím", "ům", "at", "ám", "os", "us", "ým",
            "mi", "ou", "a", "e", "i", "o", "u", "y", "ů", "é", "ě", "í",
            "á", "ý")


_CS_PALAT_PAIRS = (("čt", "ck"), ("št", "sk"), ("č", "k"), ("ž", "h"),
                   ("š", "s"), ("c", "k"), ("z", "h"))


def _cs_palatalize(w: str) -> str:
    for a, b in _CS_PALAT_PAIRS:
        if w.endswith(a):
            return w[: -len(a)] + b
    return w


def _stem_czech(w: str) -> str:
    nw = _strip_longest(w, _CS_CASE, 3)
    if nw != w:
        nw = _cs_palatalize(nw)
    return nw


# --- Polish: light stemmer (no official Snowball; CLEF-style rules) --------
_PL_NOUN = ("iami", "ami", "ach", "owie", "iach", "ów", "om", "iom", "em",
            "iem", "ie", "ia", "iu", "io", "ię", "a", "i", "y", "u", "e",
            "ą", "ę", "o")
_PL_ADJ = ("ijszych", "ijszym", "iejszy", "szych", "szymi", "szego", "szemu",
           "ego", "emu", "ych", "ymi", "ym", "ej", "im", "ich", "imi")
_PL_VERB = ("owałem", "owałam", "owali", "owały", "ować", "ałem", "ałam",
            "iłem", "iłam", "ujesz", "ujemy", "ować", "uje", "ują", "ali",
            "ały", "iły", "ił", "ał", "ać", "eć", "ić", "ąc", "ę")


def _stem_polish(w: str) -> str:
    w = _strip_longest(w, _PL_ADJ, 3)
    w = _strip_longest(w, _PL_VERB, 3)
    return _strip_longest(w, _PL_NOUN, 3)


# --- Ukrainian: light stemmer over the RV region (Russian-snowball style) --
_UK_VOWELS = "аеиоуюяіїє"
_UK_PGERUND = ("вшись", "вши", "вшися", "учи", "ючи", "ачи", "ячи", "ши")
_UK_ADJ = ("ішими", "ішого", "ішому", "ішим", "іших", "ого", "ому",
           "ими", "ій", "ий", "их", "им", "ім", "ої", "ою", "а", "е",
           "і", "у", "я", "ю")
_UK_VERB = ("ується", "уються", "еться", "уться", "иться", "аться", "ятся",
            "уємо", "уєте", "уєш", "ував", "увала", "увало", "ували", "имо",
            "ите", "ить", "ать", "ять", "уть", "ємо", "єте", "єш", "ла",
            "ло", "ли", "ти", "всь", "вся", "в", "є", "е", "у", "ю")
_UK_NOUN = ("іями", "ями", "ами", "ості", "істю", "ові", "еві", "ень",
            "ках", "ами", "ах", "ях", "ам", "ям", "ом", "ем", "єм", "ою",
            "ею", "єю", "ів", "їв", "ий", "ій", "а", "е", "и", "і", "ї",
            "о", "у", "ю", "я", "ь")


def _rv_region(w: str, vowels: str) -> int:
    for i, ch in enumerate(w):
        if ch in vowels:
            return i + 1
    return len(w)


def _stem_ukrainian(w: str) -> str:
    rv = _rv_region(w, _UK_VOWELS)
    min_stem = max(rv, 2)
    nw = _strip_longest(w, _UK_PGERUND, min_stem)
    if nw == w:
        nw = _strip_longest(nw, _UK_ADJ, min_stem)
        nw = _strip_longest(nw, _UK_VERB if nw == w else (), min_stem) \
            if nw == w else nw
        if nw == w:
            nw = _strip_longest(nw, _UK_NOUN, min_stem)
    return nw


# --- Serbian: light stemmer (Latin + transliterated digraph normalize) -----
_SR_SUF = ("ovima", "evima", "anima", "enima", "etima", "icima", "ijama",
           "cima", "inama", "ovama", "ijom", "ijim", "skih", "skim", "skog",
           "ova", "ove", "ovi", "ovo", "ovom", "ovog", "eva", "evi", "ima",
           "ama", "oga", "ome", "omu", "ega", "emu", "iju", "ije", "ija",
           "om", "og", "im", "ih", "em", "ev", "ov", "in", "a", "e", "i",
           "o", "u")


def _stem_serbian(w: str) -> str:
    w = w.replace("đ", "dj")
    return _strip_longest(w, _SR_SUF, 3)


# --- Greek: light stemmer (de-accent + final-sigma + case endings) ---------
_EL_ACCENT_FROM = "άέήίόύώϊϋΐΰ"
_EL_ACCENT_TO = "αεηιουωιυιυ"
_EL_ACCENT = str.maketrans(_EL_ACCENT_FROM, _EL_ACCENT_TO)
_EL_SUF = ("ιωνεσ", "ματων", "ματοσ", "ματα", "ουσεσ", "ουσα", "ωντασ",
           "οντασ", "ιων", "εων", "ουν", "ουσ", "εισ", "ειο", "εια", "ων",
           "ασ", "εσ", "ησ", "οσ", "ου", "οι", "αι", "α", "η", "ο", "ι",
           "ε", "υ", "ω")


def _stem_greek(w: str) -> str:
    w = w.translate(_EL_ACCENT).replace("ς", "σ")
    return _strip_longest(w, _EL_SUF, 3)


# --- Catalan: light stemmer (plural/derivational/verb endings) -------------
_CA_SUF = ("aments", "ament", "acions", "ació", "ismes", "isme", "istes",
           "ista", "ables", "able", "ibles", "ible", "esa", "eses", "itats",
           "itat", "ors", "ora", "ores", "or", "ant", "ent", "ints", "int",
           "ar", "er", "ir", "es", "os", "ns", "s", "a", "e", "o", "í", "ó")


def _stem_catalan(w: str) -> str:
    return _strip_iter(w, _CA_SUF, 3, rounds=2)


# --- Irish: Snowball-style (undo initial mutation + strip suffixes) --------
_GA_SUF = ("eachta", "achta", "eacht", "acht", "eoireacht", "óireacht",
           "aiocht", "íocht", "eoir", "óir", "each", "ach", "eog", "óg",
           "aithe", "ithe", "te", "ta", "adh", "eadh", "ail", "áil", "úil",
           "aí", "í", "a", "e")


_GA_MUT_PAIRS = (("bhf", "f"), ("mb", "b"), ("gc", "c"), ("nd", "d"),
                 ("bp", "p"), ("dt", "t"), ("ng", "g"), ("ts", "s"),
                 ("t-", ""), ("n-", ""), ("h-", ""))


def _stem_irish(w: str) -> str:
    # initial mutations: eclipsis + lenition (Snowball irish, prelude)
    for pre, rep in _GA_MUT_PAIRS:
        if w.startswith(pre):
            w = rep + w[len(pre):]
            break
    if len(w) > 3 and w[0] == "h" and w[1] in "aeiouáéíóú":
        w = w[1:]
    return _strip_longest(w, _GA_SUF, 3)


# --- Basque: case/determiner endings --------------------------------------
_EU_SUF = ("arengatik", "arentzat", "arekin", "aren", "ari", "ak", "ek",
           "en", "era", "etik", "etan", "eko", "etako", "ko", "ra", "tik",
           "tan", "az", "ez", "a", "e", "o")


def _stem_basque(w: str) -> str:
    return _strip_iter(w, _EU_SUF, 3, rounds=2)


# --- Armenian: case/plural endings -----------------------------------------
_HY_SUF = ("ներում", "ներին", "ներից", "ներով", "ների", "ները", "ներ",
           "երում", "երին", "երից", "երով", "երի", "երը", "եր", "ում",
           "ին", "ից", "ով", "ի", "ը", "ն", "ու", "ան")


def _stem_armenian(w: str) -> str:
    return _strip_longest(w, _HY_SUF, 3)


# --- Lithuanian: case endings ----------------------------------------------
_LT_SUF = ("iuose", "uose", "iams", "iais", "iomis", "ėmis", "omis", "ams",
           "ais", "ose", "ėse", "yse", "ims", "ums", "iai", "iui", "ui",
           "yje", "ėje", "oje", "ių", "ų", "as", "is", "ys", "us", "os",
           "ės", "ai", "ei", "ią", "ę", "ą", "į", "ė", "a", "i", "o", "u",
           "e", "y", "s")


def _stem_lithuanian(w: str) -> str:
    return _strip_longest(w, _LT_SUF, 3)


# --- Estonian: case endings -------------------------------------------------
_ET_SUF = ("dega", "tega", "desse", "tesse", "isse", "sse", "dele", "tele",
           "delt", "telt", "deks", "teks", "dest", "test", "ides", "ist",
           "iks", "ile", "ilt", "iga", "ita", "ina", "ini", "ga", "ta",
           "le", "lt", "ks", "st", "na", "ni", "es", "is", "de", "te",
           "id", "sid", "d", "t", "l", "s", "i", "e", "u")


def _stem_estonian(w: str) -> str:
    return _strip_longest(w, _ET_SUF, 3)


# --- Hindi: Ramanathan & Rao light stemmer (Devanagari suffix strip) -------
_HI_SUF = ("ियाँ", "ियों", "ाएँ", "ाओं", "ुओं", "ुएँ", "ियां", "ाएं",
           "ाओ", "ीं", "ों", "ें", "ाँ", "ां", "ुआ", "ुओ", "ाए", "ाइ",
           "िया", "ो", "े", "ू", "ु", "ी", "ि", "ा", "ै", "ौ", "ं")


def _stem_hindi(w: str) -> str:
    return _strip_longest(w, _HI_SUF, 1)


# --- Nepali: Devanagari suffix strip ----------------------------------------
_NE_SUF = ("हरूको", "हरूका", "हरूलाई", "हरूले", "हरूमा", "हरू", "लाई",
           "बाट", "सँग", "देखि", "सम्म", "मा", "को", "का", "की", "ले",
           "ई", "े", "ो")


def _stem_nepali(w: str) -> str:
    return _strip_longest(w, _NE_SUF, 2)


# --- Tamil: common case/plural suffixes -------------------------------------
_TA_SUF = ("களுக்கு", "களில்", "களின்", "களை", "கள்", "ிலிருந்து",
           "க்கு", "ுக்கு", "ுடன்", "ோடு", "ில்", "ின்", "ால்", "ை",
           "ாக", "ும்", "ு")


def _stem_tamil(w: str) -> str:
    w = _strip_longest(w, _TA_SUF, 2)
    # plural nasal assimilation: புத்தகம் -> புத்தகங்(கள்); undo it
    if w.endswith("ங்"):
        w = w[: -len("ங்")] + "ம்"
    return w


# --- Persian: light stemmer (clitic/plural/comparative suffixes) ------------
_FA_SUF = ("هایی", "های", "ها", "ترین", "تر", "ات", "ان", "ین", "مان",
           "تان", "شان", "م", "ت", "ش", "ی")


def _stem_persian(w: str) -> str:
    w = w.replace("‌", "")  # ZWNJ joins clitics
    return _strip_iter(w, _FA_SUF, 2, rounds=2)


# --- Indonesian: Tala's Porter-style stemmer (simplified) -------------------
_ID_PART = ("kah", "lah", "pun")
_ID_POSS = ("ku", "mu", "nya")
_ID_SUF = ("kan", "an", "i")


def _stem_indonesian(w: str) -> str:
    w = _strip_longest(w, _ID_PART, 3)
    w = _strip_longest(w, _ID_POSS, 3)
    # derivational prefixes (order matters; one removal each round)
    removed = None
    for pres in (("meng", "meny", "men", "mem", "me"),
                 ("peng", "peny", "pen", "pem", "pe"),
                 ("ber", "be"), ("ter", "te"), ("di",), ("ke",), ("se",)):
        for p in pres:
            if w.startswith(p) and len(w) - len(p) >= 3:
                cand = w[len(p):]
                # meny-/peny- assimilate s-: menyapu -> sapu
                if p in ("meny", "peny"):
                    cand = "s" + cand
                w = cand
                removed = p
                break
        else:
            continue
        break
    # ke-...-an / peng-...-an are confixes: the suffix is -an, never -kan
    # (Tala's disallowed prefix-suffix pairs)
    if removed in ("ke", "peng", "peny", "pen", "pem", "pe") \
            and w.endswith("an") and len(w) - 2 >= 3:
        return w[:-2]
    return _strip_longest(w, _ID_SUF, 3)


# --- Turkish: iterative nominal-suffix stripper with vowel harmony ----------
_TR_SUF = ("larından", "lerinden", "larına", "lerine", "larını", "lerini",
           "ların", "lerin", "ları", "leri", "lardan", "lerden", "larda",
           "lerde", "lara", "lere", "lar", "ler", "ından", "inden", "undan",
           "ünden", "ımız", "imiz", "umuz", "ümüz", "ınız", "iniz", "unuz",
           "ünüz", "ında", "inde", "unda", "ünde", "ına", "ine", "una",
           "üne", "ını", "ini", "unu", "ünü", "dan", "den", "tan", "ten",
           "da", "de", "ta", "te", "ın", "in", "un", "ün", "ım", "im",
           "um", "üm", "sı", "si", "su", "sü", "ı", "i", "u", "ü", "a",
           "e")
_TR_BACK = "aıou"
_TR_FRONT = "eiöü"


def _tr_harmony_ok(stem: str, suf: str) -> bool:
    sv = next((c for c in reversed(stem) if c in _TR_BACK + _TR_FRONT), None)
    fv = next((c for c in suf if c in _TR_BACK + _TR_FRONT), None)
    if sv is None or fv is None:
        return True
    return (sv in _TR_BACK) == (fv in _TR_BACK)


def _stem_turkish(w: str) -> str:
    for _ in range(3):
        for suf in _TR_SUF:
            if w.endswith(suf) and len(w) - len(suf) >= 2 \
                    and _tr_harmony_ok(w[: -len(suf)], suf):
                w = w[: -len(suf)]
                break
        else:
            break
    return w


# --- Yiddish: Germanic suffixes in Hebrew script + participle prefix -------
_YI_SUF = ("ערער", "סטער", "ערן", "ען", "ער", "עס", "עך", "סט", "טע",
           "ע", "ן", "ט")


def _stem_yiddish(w: str) -> str:
    if w.startswith("גע") and len(w) > 5:
        w = w[2:]
    return _strip_longest(w, _YI_SUF, 3)


# --- Sesotho: Bantu noun-class prefixes + verbal suffixes (heuristic) ------
_ST_PRE = ("bo", "di", "ma", "me", "ba", "le", "se", "mo")
_ST_SUF = ("ng", "eng", "a")


def _stem_sesotho(w: str) -> str:
    for p in _ST_PRE:
        if w.startswith(p) and len(w) - len(p) >= 3:
            w = w[len(p):]
            break
    return _strip_longest(w, _ST_SUF, 3)


# --- Lovins (1968): longest-match ending list + recoding (reduced set) -----
# The classic Lovins stemmer uses 294 endings with 29 context conditions and
# 35 recoding rules; this implementation carries the high-frequency endings
# with the no-restriction condition plus the core recodings — conservative
# but far from a full port.
_LOVINS_END = ("alistically", "arizability", "izationally", "antialness",
               "arisations", "arizations", "entialness", "ationally",
               "entations", "entiality", "ionalness", "istically",
               "izability", "izational", "ableness", "arizable",
               "entation", "entially", "eousness", "ibleness", "icalness",
               "ionalism", "ionality", "ionalize", "iousness", "izations",
               "lessness", "ability", "aically", "alistic", "alities",
               "ariness", "aristic", "arizing", "ateness", "atingly",
               "ational", "atively", "ativism", "elihood", "encible",
               "entally", "entials", "entiate", "entness", "fulness",
               "ibility", "icalism", "icalist", "icality", "icalize",
               "ication", "icianry", "ination", "ingness", "ionally",
               "isation", "ishness", "istical", "iteness", "iveness",
               "ivistic", "ivities", "ization", "izement", "oidally",
               "ousness", "aceous", "acious", "action", "alness",
               "ancial", "ancies", "ancing", "ariser", "arized",
               "arizer", "atable", "ations", "atives", "eature",
               "efully", "encies", "encing", "ential", "enting",
               "entist", "eously", "ialist", "iality", "ialize",
               "ically", "icance", "icians", "icists", "ifully",
               "ionals", "ionate", "ioning", "ionist", "iously",
               "istics", "izable", "lessly", "nesses", "oidism",
               "acies", "acity", "aging", "aical", "alism", "ality",
               "alize", "allic", "anced", "ances", "antic", "arial",
               "aries", "arily", "arity", "arize", "aroid", "ately",
               "ating", "ation", "ative", "ators", "atory", "ature",
               "early", "ehood", "eless", "ement", "enced", "ences",
               "eness", "ening", "ental", "ented", "ently", "fully",
               "ially", "icant", "ician", "icide", "icism", "icist",
               "icity", "idine", "iedly", "ihood", "inate", "iness",
               "ingly", "inism", "inity", "ional", "ioned", "ished",
               "istic", "ities", "itous", "ively", "ivity", "izers",
               "izing", "oidal", "oides", "otide", "ously", "able",
               "ably", "ages", "ally", "ance", "ancy", "ants", "aric",
               "arly", "ated", "ates", "atic", "ator", "ealy", "edly",
               "eful", "eity", "ence", "ency", "ened", "enly", "eous",
               "hood", "ials", "ians", "ible", "ibly", "ical", "ides",
               "iers", "iful", "ines", "ings", "ions", "ious", "isms",
               "ists", "itic", "ized", "izer", "less", "lily", "ness",
               "ogen", "ward", "wise", "ying", "yish", "acy", "age",
               "aic", "als", "ant", "ars", "ary", "ata", "ate", "eal",
               "ear", "ely", "ene", "ent", "ery", "ese", "ful", "ial",
               "ian", "ics", "ide", "ied", "ier", "ies", "ily", "ine",
               "ing", "ion", "ish", "ism", "ist", "ite", "ity", "ium",
               "ive", "ize", "oid", "one", "ous", "ae", "al", "ar",
               "as", "ed", "en", "es", "ia", "ic", "is", "ly", "on",
               "or", "um", "us", "yl", "a", "e", "i", "o", "s", "y")
_LOVINS_RECODE = (("iev", "ief"), ("uct", "uc"), ("umpt", "um"),
                  ("rpt", "rb"), ("urs", "ur"), ("istr", "ister"),
                  ("metr", "meter"), ("olv", "olut"), ("ul", "l"),
                  ("bex", "bic"), ("dex", "dic"), ("pex", "pic"),
                  ("tex", "tic"), ("ax", "ac"), ("ex", "ec"),
                  ("ix", "ic"), ("lux", "luc"), ("uad", "uas"),
                  ("vad", "vas"), ("cid", "cis"), ("lid", "lis"),
                  ("erid", "eris"), ("pand", "pans"), ("end", "ens"),
                  ("ond", "ons"), ("lud", "lus"), ("rud", "rus"),
                  ("her", "hes"), ("mit", "mis"), ("ent", "ens"),
                  ("ert", "ers"), ("et", "es"), ("yt", "ys"),
                  ("yz", "ys"))


def _stem_lovins(w: str) -> str:
    for suf in _LOVINS_END:
        if w.endswith(suf) and len(w) - len(suf) >= 2:
            w = w[: -len(suf)]
            break
    if len(w) >= 2 and w[-1] == w[-2] and w[-1] in "bdglmnprst":
        w = w[:-1]
    for a, b in _LOVINS_RECODE:
        if w.endswith(a):
            w = w[: -len(a)] + b
            break
    return w


_LIGHT = {
    StemmerType.Armenian: _stem_armenian,
    StemmerType.Basque: _stem_basque,
    StemmerType.Catalan: _stem_catalan,
    StemmerType.Czech: _stem_czech,
    StemmerType.Esperanto: _stem_esperanto,
    StemmerType.Estonian: _stem_estonian,
    StemmerType.Greek: _stem_greek,
    StemmerType.Hindi: _stem_hindi,
    StemmerType.Indonesian: _stem_indonesian,
    StemmerType.Irish: _stem_irish,
    StemmerType.Lithuanian: _stem_lithuanian,
    StemmerType.Lovins: _stem_lovins,
    StemmerType.Nepali: _stem_nepali,
    StemmerType.Persian: _stem_persian,
    StemmerType.Polish: _stem_polish,
    StemmerType.Serbian: _stem_serbian,
    StemmerType.Sesotho: _stem_sesotho,
    StemmerType.Tamil: _stem_tamil,
    StemmerType.Turkish: _stem_turkish,
    StemmerType.Ukrainian: _stem_ukrainian,
    StemmerType.Yiddish: _stem_yiddish,
}


def get_stem_fn(st: StemmerType):
    """Stemmer callable for a StemmerType, or None for Null.

    English/Porter use the in-repo Porter implementation (tokenizer.py,
    mirrored byte-identically in native/seekstorm_native.cpp)."""
    if st in (StemmerType.Null,):
        return None
    if st in (StemmerType.English, StemmerType.Porter):
        from .tokenizer import porter_stem

        return porter_stem
    # native Snowball port (snowball.cpp) when built: byte-exact vs NLTK
    # (tests/test_stemmers.py golden vectors) and ~30x faster per token,
    # and identical to what the C++ ingest fast path applies
    from .native import snowball_stem_fn

    fn = snowball_stem_fn(st.value)
    if fn is not None:
        return fn
    lang = _NLTK_LANG.get(st)
    if lang is not None:
        return _nltk_stem_fn(lang)
    fn = _LIGHT.get(st)
    if fn is not None:
        return fn
    return None


def supported() -> list[str]:
    """All stemmer names with a working implementation."""
    out = [StemmerType.English.value, StemmerType.Porter.value]
    out += [s.value for s in _NLTK_LANG]
    out += [s.value for s in _LIGHT]
    return sorted(set(out))
