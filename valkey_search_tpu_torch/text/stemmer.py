"""Snowball 3.0.1 "english" stemmer, self-contained pure Python.

Copied unchanged from valkey_search_tpu/text/stemmer.py.

The reference vendors snowball v3.0.1 and stems through `sb_stemmer`
(src/indexes/text/lexer.cc GetStemmer/StemWordInPlace,
third_party/snowball VERSION=v3.0.1, English only). This is an
independent implementation of the published snowball 3.0.1 english
algorithm — NOT the older Porter2 most ports implement. Notable 3.0.x
behaviors: extended R1 exception prefixes (arsen/commun/emerg/gener/
later/organ/past/univers), `[consonant]ying -> ie` (dying->die),
`ogist -> og`, stems ending "past" count as a short syllable, doubles
preceded by a/e/o at word start are not undoubled (egg stays egg), and
eed/ing no-op exceptions keyed by the full remainder (proceed, canning,
evening, ...). Validated against the snowball C build in
tests/test_text_lexer.py via a generated golden file.

R1/R2 are fixed character positions computed once after the prelude;
suffix conditions compare the suffix start index against them, so
length-changing replacements behave exactly like the C cursor model.
"""

from __future__ import annotations

_VOWELS = frozenset("aeiouy")  # 'Y' (consonant-marked y) is excluded
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDING = frozenset("cdeghkmnrt")
_R1_PREFIXES = ("arsen", "commun", "emerg", "gener", "later", "organ",
                "past", "univers")

# Whole-word exceptions (checked before anything else).
_EXCEPTIONS = {
    "andes": "andes", "atlas": "atlas", "bias": "bias", "cosmos": "cosmos",
    "howe": "howe", "news": "news", "sky": "sky",
    "skies": "sky", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
}

# eed/eedly no-op when the remainder before the suffix is exactly one of:
_EED_EXCEPTION_STEMS = frozenset(("succ", "proc", "exc"))
# ing/ingly no-op when the remainder is exactly one of:
_ING_EXCEPTION_STEMS = frozenset(("even", "cann", "inn", "earr", "herr", "out"))


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS


def _mark_regions(word: str) -> tuple:
    n = len(word)
    p1 = p2 = n
    start = None
    for pre in _R1_PREFIXES:
        if word.startswith(pre):
            start = len(pre)
            break
    if start is None:
        i = 0
        while i < n and not _is_vowel(word, i):
            i += 1
        while i < n and _is_vowel(word, i):
            i += 1
        if i < n:
            start = i + 1  # past the non-vowel
        else:
            return p1, p2
        # note: `start` here is already past the first vowel..non-vowel run
        p1 = start
    else:
        p1 = start
    i = p1
    while i < n and not _is_vowel(word, i):
        i += 1
    while i < n and _is_vowel(word, i):
        i += 1
    if i < n:
        p2 = i + 1
    return p1, p2


def _ends_short_syllable(word: str) -> bool:
    """snowball 3.x shortv: C-V-C(not w,x,Y) at end, or V-C as the whole
    word, or the stem ends with literal "past"."""
    n = len(word)
    if n >= 3 and (
        not _is_vowel(word, n - 3)
        and _is_vowel(word, n - 2)
        and not _is_vowel(word, n - 1)
        and word[n - 1] not in "wx" and word[n - 1] != "Y"
    ):
        return True
    if n == 2 and _is_vowel(word, 0) and not _is_vowel(word, 1):
        return True
    if word.endswith("past"):
        return True
    return False


def _has_vowel(word: str, end: int) -> bool:
    return any(_is_vowel(word, i) for i in range(max(0, end)))


def stem(word: str) -> str:
    """Stem one lowercase word (snowball 3.0.1 english)."""
    exc = _EXCEPTIONS.get(word)
    if exc is not None:
        return exc
    if len(word) < 3:
        return word

    # Prelude: strip one leading apostrophe; mark consonant-y as Y.
    if word[0] == "'":
        word = word[1:]
        if len(word) < 1:
            return word
    chars = list(word)
    y_found = False
    if chars and chars[0] == "y":
        chars[0] = "Y"
        y_found = True
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
            y_found = True
    word = "".join(chars)

    p1, p2 = _mark_regions(word)

    def in_r1(suffix_len: int) -> bool:
        return len(word) - suffix_len >= p1

    def in_r2(suffix_len: int) -> bool:
        return len(word) - suffix_len >= p2

    # Step 1a: possessives.
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            break
    # Step 1a: plural forms.
    if word.endswith("sses"):
        word = word[:-4] + "ss"
    elif word.endswith("ied") or word.endswith("ies"):
        word = word[:-3] + ("i" if len(word) >= 5 else "ie")
    elif word.endswith("us") or word.endswith("ss"):
        pass
    elif word.endswith("s"):
        if _has_vowel(word, len(word) - 2):
            word = word[:-1]

    # Step 1b.
    suf = None
    for s in ("eedly", "ingly", "edly", "eed", "ing", "ed"):
        if word.endswith(s):
            suf = s
            break
    if suf in ("eed", "eedly"):
        if word[: -len(suf)] not in _EED_EXCEPTION_STEMS:
            if in_r1(len(suf)):
                word = word[: -len(suf)] + "ee"
    elif suf is not None:
        handled = False
        if suf in ("ing", "ingly") and suf == "ing":
            stem_part = word[:-3]
            if stem_part in _ING_EXCEPTION_STEMS:
                handled = True
            elif (
                len(stem_part) == 2
                and stem_part[1] in "yY"
                and not _is_vowel(stem_part, 0)
            ):
                # [single consonant] + y + ing -> ie (dying -> die)
                word = stem_part[0] + "ie"
                handled = True
        if not handled:
            stem_part = word[: -len(suf)]
            if _has_vowel(stem_part, len(stem_part)):
                word = stem_part
                if word.endswith(("at", "bl", "iz")):
                    word += "e"
                elif word.endswith(_DOUBLES):
                    # 3.x: keep the double when preceded by a/e/o at start
                    # ("egg", "add", "odd", "off", "ebb" stay doubled).
                    if not (len(word) == 3 and word[0] in "aeo"):
                        word = word[:-1]
                elif len(word) == p1 and _ends_short_syllable(word):
                    word += "e"

    # Step 1c: y/Y -> i after a non-vowel that is not the first letter.
    if (
        len(word) > 2
        and word[-1] in "yY"
        and not _is_vowel(word, len(word) - 2)
    ):
        word = word[:-1] + "i"

    # Step 2 (longest suffix; condition: suffix in R1).
    step2 = (
        ("ization", "ize"), ("ational", "ate"), ("fulness", "ful"),
        ("ousness", "ous"), ("iveness", "ive"),
        ("tional", "tion"), ("biliti", "ble"), ("lessli", "less"),
        ("entli", "ent"), ("ation", "ate"), ("alism", "al"),
        ("aliti", "al"), ("ousli", "ous"), ("iviti", "ive"),
        ("fulli", "ful"), ("ogist", "og"),
        ("enci", "ence"), ("anci", "ance"), ("abli", "able"),
        ("izer", "ize"), ("ator", "ate"), ("alli", "al"),
        ("ogi", None), ("bli", "ble"),
        ("li", None),
    )
    for s, rep in step2:
        if word.endswith(s):
            if s == "ogi":
                if in_r1(3) and len(word) >= 4 and word[-4] == "l":
                    word = word[:-3] + "og"
            elif s == "li":
                if in_r1(2) and len(word) >= 3 and word[-3] in _LI_ENDING:
                    word = word[:-2]
            elif in_r1(len(s)):
                word = word[: -len(s)] + rep
            break

    # Step 3 (condition: in R1; 'ative' additionally requires R2).
    step3 = (
        ("ational", "ate"), ("tional", "tion"), ("ative", None),
        ("alize", "al"), ("icate", "ic"), ("iciti", "ic"),
        ("ical", "ic"), ("ness", ""), ("ful", ""),
    )
    for s, rep in step3:
        if word.endswith(s):
            if s == "ative":
                if in_r1(5) and in_r2(5):
                    word = word[:-5]
            elif in_r1(len(s)):
                word = word[: -len(s)] + rep
            break

    # Step 4 (condition: in R2).
    step4 = (
        "ement", "ance", "ence", "able", "ible", "ment",
        "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
        "ion", "al", "er", "ic",
    )
    for s in step4:
        if word.endswith(s):
            if s == "ion":
                if in_r2(3) and len(word) >= 4 and word[-4] in "st":
                    word = word[:-3]
            elif in_r2(len(s)):
                word = word[: -len(s)]
            break

    # Step 5.
    if word.endswith("e"):
        if in_r2(1):
            word = word[:-1]
        elif in_r1(1) and not _ends_short_syllable(word[:-1]):
            word = word[:-1]
    elif word.endswith("l"):
        if in_r2(1) and len(word) >= 2 and word[-2] == "l":
            word = word[:-1]

    if y_found:
        word = word.replace("Y", "y")
    return word
