"""Tokenization and universal POS tagging for offline preprocessing: the
port's copy of ``insenticap_model_tpu/text.py``.

The reference uses nltk.word_tokenize + nltk.pos_tag_sents(tagset=
'universal') (reference preprocess.py:71-73,108-109). As in the JAX
package:

  * ``tokenize`` is nltk's Treebank word tokenization (word_tokenize over
    one caption sentence is Treebank tokenization). The JAX package
    imports nltk for it; the port runs where nltk is absent, so it uses
    its own copy of nltk's tokenizer (``nltk_text.treebank_tokenize``),
    which gives nltk's tokens;
  * ``pos_tag`` tags with nltk's perceptron tagger where nltk and its
    data are installed (``_nltk_tagger``, unchanged), otherwise with the
    built-in rule tagger (closed-class lexicon + suffix rules; the same
    lexicons and rules as the JAX package's). Tag assignments can differ
    from the reference's perceptron tagger (SURVEY.md §2.5: any
    equivalent tagger is acceptable; the artefact schemas are unchanged).

Only four tag distinctions matter downstream: '.' (dropped), NOUN/VERB
(concept words, preprocess.py concept_pos), and ADJ (sentiment-word mining).
"""
from __future__ import annotations

import re
from typing import List, Sequence, Tuple

from .nltk_text import treebank_tokenize

_PUNCT_RE = re.compile(r"^[^\w]+$")
_NUM_RE = re.compile(r"^\d+([.,:\-/]\d+)*$")

_DET = {"a", "an", "the", "this", "that", "these", "those", "some", "any",
        "each", "every", "no", "either", "neither", "both", "all", "such"}
_PRON = {"i", "you", "he", "she", "it", "we", "they", "me", "him", "her",
         "us", "them", "my", "your", "his", "its", "our", "their", "mine",
         "yours", "hers", "ours", "theirs", "myself", "yourself", "himself",
         "herself", "itself", "ourselves", "themselves", "who", "whom",
         "whose", "which", "what", "someone", "something", "anyone",
         "anything", "everyone", "everything", "nobody", "nothing"}
_ADP = {"in", "on", "at", "by", "for", "with", "about", "against", "between",
        "into", "through", "during", "before", "after", "above", "below",
        "to", "from", "up", "down", "of", "off", "over", "under", "near",
        "behind", "beside", "beyond", "around", "among", "across", "along",
        "onto", "upon", "within", "without", "toward", "towards", "inside",
        "outside", "underneath", "past"}
_CONJ = {"and", "or", "but", "nor", "so", "yet", "because", "although",
         "though", "while", "if", "unless", "until", "when", "whenever",
         "where", "wherever", "whereas", "than", "as"}
_PRT = {"not", "n't", "'s", "'ll", "'re", "'ve", "'d", "'m", "out"}
_NUM_WORDS = {"zero", "one", "two", "three", "four", "five", "six",
              "seven", "eight", "nine", "ten", "eleven", "twelve",
              "thirteen", "fourteen", "fifteen", "sixteen", "seventeen",
              "eighteen", "nineteen", "twenty", "thirty", "forty",
              "fifty", "sixty", "seventy", "eighty", "ninety", "hundred",
              "thousand", "million", "first", "second", "third"}
_VERB_STEMS = {"sleep", "shout", "smile", "laugh", "cry", "talk", "speak",
               "watch", "wait", "throw", "catch", "kick", "climb", "swim",
               "drive", "pull", "push", "carry", "lift", "drink", "cook",
               "read", "write", "draw", "point", "reach", "touch", "lean",
               "rest", "pose", "race", "chase", "feed", "drop", "lay",
               "lie", "hang", "surf", "ski", "skate", "dance", "sing",
               "travel", "sail", "serve", "cut", "graze", "gather",
               "perform", "browse", "stare", "gaze", "glance"}
_AUX_VERBS = {"is", "am", "are", "was", "were", "be", "been", "being",
              "have", "has", "had", "having", "do", "does", "did", "doing",
              "will", "would", "shall", "should", "can", "could", "may",
              "might", "must", "get", "gets", "got", "getting", "go",
              "goes", "went", "gone", "going", "make", "makes", "made",
              "making", "take", "takes", "took", "taken", "taking", "see",
              "sees", "saw", "seen", "look", "looks", "looked", "looking",
              "sit", "sits", "sat", "sitting", "stand", "stands", "stood",
              "standing", "walk", "walks", "walked", "walking", "run",
              "runs", "ran", "running", "hold", "holds", "held", "holding",
              "wear", "wears", "wore", "wearing", "play", "plays",
              "played", "playing", "ride", "rides", "rode", "riding",
              "eat", "eats", "ate", "eating", "jump", "jumps", "jumped",
              "jumping", "fly", "flies", "flew", "flying", "smile",
              "smiles", "smiled", "smiling"}
_ADV = {"very", "too", "quite", "rather", "really", "just", "also", "then",
        "there", "here", "now", "again", "always", "never", "often",
        "sometimes", "usually", "together", "away", "back", "still",
        "almost", "even", "only", "well", "far", "much", "more", "most",
        "less", "least", "how", "why", "soon", "already", "perhaps"}
# frequent English adjectives, weighted toward sentiment vocabulary — the
# mining stage (preprocess.py:142-158) keys on ADJ tags
_ADJ = {"good", "bad", "happy", "sad", "great", "nice", "beautiful", "ugly",
        "lovely", "amazing", "awesome", "wonderful", "terrible", "horrible",
        "awful", "pretty", "cute", "gorgeous", "stunning", "delicious",
        "tasty", "fresh", "stale", "dirty", "clean", "old", "new", "young",
        "big", "small", "large", "little", "tall", "short", "long", "high",
        "low", "hot", "cold", "warm", "cool", "dark", "bright", "light",
        "heavy", "fast", "slow", "busy", "quiet", "loud", "calm", "angry",
        "excited", "bored", "tired", "hungry", "thirsty", "lonely",
        "crowded", "empty", "full", "rich", "poor", "cheap", "expensive",
        "free", "open", "closed", "wet", "dry", "soft", "hard", "smooth",
        "rough", "sharp", "dull", "strong", "weak", "healthy", "sick",
        "dead", "alive", "safe", "dangerous", "easy", "difficult", "simple",
        "complex", "funny", "serious", "strange", "weird", "normal",
        "special", "perfect", "broken", "damaged", "favorite", "delightful",
        "charming", "elegant", "graceful", "majestic", "peaceful",
        "pleasant", "unpleasant", "scary", "creepy", "gloomy", "sunny",
        "cloudy", "rainy", "snowy", "windy", "foggy", "colorful", "shiny",
        "sparkling", "vibrant", "dull", "pale", "crazy", "silly", "smart",
        "stupid", "clever", "brave", "shy", "friendly", "mean", "kind",
        "cruel", "gentle", "wild", "tame", "fat", "thin", "skinny",
        "plump", "red", "blue", "green", "yellow", "white", "black",
        "brown", "gray", "grey", "orange", "purple", "pink", "golden",
        "wooden", "plastic", "metal", "glass", "many", "few", "several",
        "other", "another", "same", "different", "various", "certain",
        "male", "female", "adorable", "disgusting", "filthy", "nasty",
        "splendid", "marvelous", "fantastic", "superb", "fine", "grand",
        "evil", "foolish", "glad", "proud", "eager", "anxious", "nervous",
        "confident", "curious", "grateful", "jealous", "guilty", "ashamed",
        "depressed", "miserable", "cheerful", "joyful", "content"}

_ADJ_SUFFIXES = ("ful", "ous", "ive", "able", "ible", "less", "ish",
                 "ic", "ary", "ate", "ent", "ant")
_ADV_SUFFIX = "ly"
_VERB_SUFFIXES = ("ing", "ed")


def tokenize(text: str) -> List[str]:
    """Treebank word tokenization of one sentence (data-free)."""
    return treebank_tokenize(text)


def _rule_tag(w: str) -> str:
    lw = w.lower()
    if _PUNCT_RE.match(w):
        return "."
    if _NUM_RE.match(w) or lw in _NUM_WORDS:
        return "NUM"
    if lw in _DET:
        return "DET"
    if lw in _PRON:
        return "PRON"
    if lw in _ADP:
        return "ADP"
    if lw in _CONJ:
        return "CONJ"
    if lw in _PRT:
        return "PRT"
    if lw in _ADJ:
        return "ADJ"
    if lw in _AUX_VERBS or lw in _VERB_STEMS:
        return "VERB"
    if lw.endswith("s") and lw[:-1] in _VERB_STEMS:
        return "VERB"  # 3rd-person singular of the verb lexicon
    if lw in _ADV:
        return "ADV"
    if lw.endswith(_ADV_SUFFIX) and len(lw) > 4:
        return "ADV"
    for suf in _ADJ_SUFFIXES:
        if lw.endswith(suf) and len(lw) > len(suf) + 2:
            return "ADJ"
    for suf in _VERB_SUFFIXES:
        if lw.endswith(suf) and len(lw) > len(suf) + 2:
            return "VERB"
    return "NOUN"


_NLTK_TAGGER = None
_NLTK_CHECKED = False


def _nltk_tagger():
    """Use nltk's trained tagger when its data is actually installed."""
    global _NLTK_TAGGER, _NLTK_CHECKED
    if not _NLTK_CHECKED:
        _NLTK_CHECKED = True
        try:
            import nltk
            nltk.pos_tag(["test"], tagset="universal")
            _NLTK_TAGGER = lambda ws: nltk.pos_tag(ws, tagset="universal")
        except Exception:
            _NLTK_TAGGER = None
    return _NLTK_TAGGER


def pos_tag(words: Sequence[str]) -> List[Tuple[str, str]]:
    """Universal-tagset POS tags for one tokenized sentence."""
    if not words:
        return []
    tagger = _nltk_tagger()
    if tagger is not None:
        return tagger(list(words))
    return [(w, _rule_tag(w)) for w in words]


def pos_tag_sents(sents: Sequence[Sequence[str]]):
    return [pos_tag(s) for s in sents]
