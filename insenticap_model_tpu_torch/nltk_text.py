"""nltk's Treebank word tokenizer and Porter stemmer, copied.

The JAX package tokenizes with nltk's ``TreebankWordTokenizer``
(insenticap_model_tpu/text.py:24) and METEOR* stems with nltk's
``PorterStemmer`` (rewards/meteor.py:86-91). nltk is not installed where
the port runs, so the port keeps its own copies of the two, taken from
nltk 3.10.0:

* ``treebank_tokenize``: ``nltk.tokenize.treebank.TreebankWordTokenizer
  .tokenize`` in its default mode (``convert_parentheses=False``), with
  the contraction lists of ``nltk.tokenize.destructive
  .MacIntyreContractions``; the same regular expressions, applied in the
  same order;
* ``PorterStemmer``: ``nltk.stem.porter.PorterStemmer`` in its default
  ``NLTK_EXTENSIONS`` mode, and that mode only (the irregular forms, the
  two-letter cvc rule, the ``-ied``/``-ies`` and ``-y`` rules, ``alli``,
  ``fulli`` and ``logi``).

The tests hold both against nltk itself on every input they try.

Copyright (C) 2001-2026 NLTK Project. Authors of the originals: Edward
Loper, Michael Heilman, Tom Aarsen (tokenizer); Vivake Gupta, Barry
Wilkins, Stuart Barr, Mark Amery and the NLTK contributors (stemmer; the
algorithm is Martin Porter's, "An algorithm for suffix stripping",
Program 14.3 (1980): 130-137).

Licensed under the Apache License, Version 2.0 (the "License"); you may
not use this file except in compliance with the License. You may obtain a
copy of the License at

    http://www.apache.org/licenses/LICENSE-2.0

Unless required by applicable law or agreed to in writing, software
distributed under the License is distributed on an "AS IS" BASIS, WITHOUT
WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied. See the
License for the specific language governing permissions and limitations
under the License. This file is a modified copy: the two classes' default
paths only, restated as functions and one class.
"""
from __future__ import annotations

import re
from typing import List

# ---------------------------------------------------------------------------
# Treebank tokenizer (nltk/tokenize/treebank.py, destructive.py)
# ---------------------------------------------------------------------------

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # the final period
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")
_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")
_ENDING_QUOTES = [
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
# MacIntyreContractions.CONTRACTIONS2 / CONTRACTIONS3 (CONTRACTIONS4 is
# unused by the tokenizer, as in the sed script it ports)
_CONTRACTIONS2 = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
)]
_CONTRACTIONS3 = [re.compile(p) for p in (
    r"(?i) ('t)(?#X)(is)\b", r"(?i) ('t)(?#X)(was)\b")]


def treebank_tokenize(text: str) -> List[str]:
    """``TreebankWordTokenizer().tokenize(text)``."""
    for regexp, substitution in _STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in _PUNCTUATION:
        text = regexp.sub(substitution, text)
    regexp, substitution = _PARENS_BRACKETS
    text = regexp.sub(substitution, text)
    regexp, substitution = _DOUBLE_DASHES
    text = regexp.sub(substitution, text)
    text = " " + text + " "
    for regexp, substitution in _ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


# ---------------------------------------------------------------------------
# Porter stemmer, NLTK_EXTENSIONS mode (nltk/stem/porter.py)
# ---------------------------------------------------------------------------

_IRREGULAR_FORMS = {
    "sky": ["sky", "skies"],
    "die": ["dying"],
    "lie": ["lying"],
    "tie": ["tying"],
    "news": ["news"],
    "inning": ["innings", "inning"],
    "outing": ["outings", "outing"],
    "canning": ["cannings", "canning"],
    "howe": ["howe"],
    "proceed": ["proceed"],
    "exceed": ["exceed"],
    "succeed": ["succeed"],
}
_VOWELS = frozenset("aeiou")


class PorterStemmer:
    """``nltk.stem.porter.PorterStemmer()`` (its default mode)."""

    def __init__(self):
        self.pool = {val: key for key, vals in _IRREGULAR_FORMS.items()
                     for val in vals}

    @staticmethod
    def _is_consonant(word, i):
        if word[i] in _VOWELS:
            return False
        if word[i] == "y":
            negate = False
            while i > 0 and word[i] == "y":
                negate = not negate
                i -= 1
            return (word[i] not in _VOWELS) != negate
        return True

    def _measure(self, stem):
        cv = "".join("c" if self._is_consonant(stem, i) else "v"
                     for i in range(len(stem)))
        return cv.count("vc")

    def _has_positive_measure(self, stem):
        return self._measure(stem) > 0

    def _contains_vowel(self, stem):
        return any(not self._is_consonant(stem, i) for i in range(len(stem)))

    def _ends_double_consonant(self, word):
        return (len(word) >= 2 and word[-1] == word[-2]
                and self._is_consonant(word, len(word) - 1))

    def _ends_cvc(self, word):
        return (len(word) >= 3
                and self._is_consonant(word, len(word) - 3)
                and not self._is_consonant(word, len(word) - 2)
                and self._is_consonant(word, len(word) - 1)
                and word[-1] not in ("w", "x", "y")) or (
            len(word) == 2 and not self._is_consonant(word, 0)
            and self._is_consonant(word, 1))

    @staticmethod
    def _replace_suffix(word, suffix, replacement):
        return word + replacement if suffix == "" \
            else word[:-len(suffix)] + replacement

    def _apply_rule_list(self, word, rules):
        """The first rule whose suffix the word ends with decides: its
        replacement where its condition holds, else the word unchanged."""
        for suffix, replacement, condition in rules:
            if suffix == "*d" and self._ends_double_consonant(word):
                stem = word[:-2]
                if condition is None or condition(stem):
                    return stem + replacement
                return word
            if word.endswith(suffix):
                stem = self._replace_suffix(word, suffix, "")
                if condition is None or condition(stem):
                    return stem + replacement
                return word
        return word

    def _step1a(self, word):
        if word.endswith("ies") and len(word) == 4:
            return self._replace_suffix(word, "ies", "ie")
        return self._apply_rule_list(word, [
            ("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None),
            ("s", "", None)])

    def _step1b(self, word):
        if word.endswith("ied"):
            return self._replace_suffix(word, "ied",
                                        "ie" if len(word) == 4 else "i")
        if word.endswith("eed"):
            stem = self._replace_suffix(word, "eed", "")
            return stem + "ee" if self._measure(stem) > 0 else word
        for suffix in ("ed", "ing"):
            if word.endswith(suffix):
                stem = self._replace_suffix(word, suffix, "")
                if self._contains_vowel(stem):
                    break
        else:
            return word
        return self._apply_rule_list(stem, [
            ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
            ("*d", stem[-1], lambda _: stem[-1] not in ("l", "s", "z")),
            ("", "e", lambda s: self._measure(s) == 1 and self._ends_cvc(s)),
        ])

    def _step1c(self, word):
        return self._apply_rule_list(word, [(
            "y", "i",
            lambda s: len(s) > 1 and self._is_consonant(s, len(s) - 1))])

    def _step2(self, word):
        pos = self._has_positive_measure
        if word.endswith("alli") and pos(self._replace_suffix(word, "alli",
                                                              "")):
            return self._step2(self._replace_suffix(word, "alli", "al"))
        return self._apply_rule_list(word, [
            ("ational", "ate", pos), ("tional", "tion", pos),
            ("enci", "ence", pos), ("anci", "ance", pos),
            ("izer", "ize", pos), ("bli", "ble", pos), ("alli", "al", pos),
            ("entli", "ent", pos), ("eli", "e", pos), ("ousli", "ous", pos),
            ("ization", "ize", pos), ("ation", "ate", pos),
            ("ator", "ate", pos), ("alism", "al", pos),
            ("iveness", "ive", pos), ("fulness", "ful", pos),
            ("ousness", "ous", pos), ("aliti", "al", pos),
            ("iviti", "ive", pos), ("biliti", "ble", pos),
            ("fulli", "ful", pos),
            ("logi", "log", lambda _: pos(word[:-3])),
        ])

    def _step3(self, word):
        pos = self._has_positive_measure
        return self._apply_rule_list(word, [
            ("icate", "ic", pos), ("ative", "", pos), ("alize", "al", pos),
            ("iciti", "ic", pos), ("ical", "ic", pos), ("ful", "", pos),
            ("ness", "", pos)])

    def _step4(self, word):
        def gt1(stem):
            return self._measure(stem) > 1
        return self._apply_rule_list(word, [
            ("al", "", gt1), ("ance", "", gt1), ("ence", "", gt1),
            ("er", "", gt1), ("ic", "", gt1), ("able", "", gt1),
            ("ible", "", gt1), ("ant", "", gt1), ("ement", "", gt1),
            ("ment", "", gt1), ("ent", "", gt1),
            ("ion", "", lambda s: self._measure(s) > 1
             and s[-1] in ("s", "t")),
            ("ou", "", gt1), ("ism", "", gt1), ("ate", "", gt1),
            ("iti", "", gt1), ("ous", "", gt1), ("ive", "", gt1),
            ("ize", "", gt1)])

    def _step5a(self, word):
        if word.endswith("e"):
            stem = self._replace_suffix(word, "e", "")
            if self._measure(stem) > 1:
                return stem
            if self._measure(stem) == 1 and not self._ends_cvc(stem):
                return stem
        return word

    def _step5b(self, word):
        return self._apply_rule_list(
            word, [("ll", "l", lambda _: self._measure(word[:-1]) > 1)])

    def stem(self, word: str) -> str:
        """The stem of ``word``, lowercased first (nltk's
        ``to_lowercase=True``)."""
        stem = word.lower()
        if stem in self.pool:
            return self.pool[stem]
        if len(word) <= 2:
            return stem
        for step in (self._step1a, self._step1b, self._step1c, self._step2,
                     self._step3, self._step4, self._step5a, self._step5b):
            stem = step(stem)
        return stem
