"""The port's text processing against nltk and the JAX package on the CPU:
its copy of nltk's Treebank tokenizer (``nltk_text.treebank_tokenize``,
``text.tokenize``) and of nltk's Porter stemmer (``nltk_text
.PorterStemmer``, METEOR*'s stem stage) against nltk itself, the rule
tagger (``text.pos_tag_sents``) against the JAX package's, and the same
results in a process where nltk cannot be imported (the card's machine has
no nltk). Every comparison is exact.
"""
import json
import os
import subprocess
import sys

import pytest
from hypothesis import given, settings, strategies as st

nltk_tb = pytest.importorskip("nltk.tokenize.treebank")
nltk_porter = pytest.importorskip("nltk.stem.porter")

from insenticap_model_tpu import text as jtext  # noqa: E402 (needs nltk)
from insenticap_model_tpu.rewards import meteor as jmeteor  # noqa: E402
from insenticap_model_tpu_torch import nltk_text, synthetic  # noqa: E402
from insenticap_model_tpu_torch import text as ttext  # noqa: E402
from insenticap_model_tpu_torch.rewards import meteor as tmeteor  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = nltk_tb.TreebankWordTokenizer()
STEMMER = nltk_porter.PorterStemmer()

SENTENCES = [
    "A man, who runs quickly!",
    "the happy dog runs in the park.",
    "Good muffins cost $3.88\nin New York.  Please buy me\ntwo of them.",
    "They'll save and invest more.",
    "hi, my name can't hello,",
    '"Quoted" text (in parens) [and brackets] {braces} <angles>.',
    "It's 'tis the season -- gonna wanna gimme lemme cannot d'ye more'n",
    "Wait... what?! 3,000 people; 50% off & #1 @home: yes",
    "She said ''hello'' and ``bye'' -- don't WON'T I'M we'VE",
    "a dog 's toy , the cats' bowl .",
    "",
    "   ",
]

# every suffix a rule of the stemmer names, and roots that meet each
# rule's conditions (measure 0, 1, 2+, cvc endings, double consonants, y)
SUFFIXES = [
    "", "s", "ss", "sses", "ies", "ied", "eed", "ed", "ing", "at", "bl",
    "iz", "y", "ational", "tional", "enci", "anci", "izer", "bli", "abli",
    "alli", "entli", "eli", "ousli", "ization", "ation", "ator", "alism",
    "iveness", "fulness", "ousness", "aliti", "iviti", "biliti", "fulli",
    "logi", "icate", "ative", "alize", "iciti", "ical", "ful", "ness", "al",
    "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment",
    "ent", "sion", "tion", "ion", "ou", "ism", "ate", "iti", "ous", "ive",
    "ize", "e", "ll", "ly"]
ROOTS = [
    "", "a", "b", "y", "ab", "tr", "by", "tree", "hop", "hopp", "tann",
    "fall", "hiss", "fizz", "fail", "fil", "conflat", "troubl", "siz",
    "agr", "plast", "bl", "mot", "s", "connect", "relat", "condit",
    "val", "hesit", "digit", "conform", "radic", "differ", "vil",
    "analog", "vietnam", "predic", "oper", "feud", "decis", "hope",
    "call", "form", "sensit", "sensib", "tripl", "electr", "good",
    "reviv", "allow", "infer", "airlin", "gyroscop", "adjust", "defens",
    "irrit", "replac", "depend", "adopt", "homolog", "commun", "activ",
    "angular", "effect", "bowdler", "prob", "r", "ceas", "controll",
    "roll", "sky", "spy", "fly", "enjoy", "happ", "toy", "syzyg", "cry",
    "ski", "day", "play", "sta", "oat", "ivy", "orrery"]
IRREGULAR = ["sky", "skies", "dying", "lying", "tying", "news",
             "innings", "inning", "outings", "outing", "cannings",
             "canning", "howe", "proceed", "exceed", "succeed", "Skies",
             "NEWS", "Dying"]


def _lexicon_words():
    words = set()
    for name in ("_DET", "_PRON", "_ADP", "_CONJ", "_PRT", "_NUM_WORDS",
                 "_VERB_STEMS", "_AUX_VERBS", "_ADV", "_ADJ"):
        words |= getattr(jtext, name)
    return sorted(words)


STEM_WORDS = sorted(set(
    _lexicon_words() + sorted(jmeteor.FUNCTION_WORDS) + synthetic.WORDS
    + [r + s for r in ROOTS for s in SUFFIXES if r + s] + IRREGULAR
    + [w.capitalize() for w in synthetic.WORDS]))


@pytest.mark.parametrize("sentence", SENTENCES)
def test_tokenize_equals_nltk_treebank(sentence):
    want = TOKENIZER.tokenize(sentence)
    assert nltk_text.treebank_tokenize(sentence) == want
    assert ttext.tokenize(sentence) == jtext.tokenize(sentence) == want


_PIECES = st.sampled_from([
    "a", "dog", "Man", "x", "3", "42", "3.88", "1,000", "'", '"', "''",
    "``", "(", ")", "[", "]", "{", "}", "<", ">", "-", "--", "...", ".",
    ",", ":", ";", "!", "?", "$", "%", "&", "@", "#", "n't", "'s", "'ll",
    "'re", "'ve", "'d", "'m", "can't", "don't", "WON'T", "cannot",
    "gonna", "wanna", "gimme", "'tis", "'twas", "more'n", "d'ye", " ",
    "  ", "\n", "\t"])


@settings(max_examples=400, deadline=None)
@given(st.lists(_PIECES, max_size=14).map("".join))
def test_tokenize_equals_nltk_on_generated_text(s):
    assert nltk_text.treebank_tokenize(s) == TOKENIZER.tokenize(s)


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet="abcdXYZ019'\"()[]{}<>-.,:;!?$%&@# \n",
               max_size=30))
def test_tokenize_equals_nltk_on_random_characters(s):
    assert nltk_text.treebank_tokenize(s) == TOKENIZER.tokenize(s)


def test_porter_stemmer_equals_nltk():
    """The lexicons of the rule tagger, METEOR*'s function words, the
    synthetic vocabulary, every root x every rule's suffix and the
    irregular forms."""
    ours = nltk_text.PorterStemmer()
    assert len(STEM_WORDS) > 5000
    diff = [(w, ours.stem(w), STEMMER.stem(w)) for w in STEM_WORDS
            if ours.stem(w) != STEMMER.stem(w)]
    assert not diff, diff[:20]
    assert [tmeteor._stem(w) for w in STEM_WORDS] == \
        [jmeteor._stem(w) for w in STEM_WORDS]


@settings(max_examples=400, deadline=None)
@given(st.text(alphabet="abcdeilnorstuyz", min_size=1, max_size=14))
def test_porter_stemmer_equals_nltk_on_generated_words(w):
    assert nltk_text.PorterStemmer().stem(w) == STEMMER.stem(w)


def test_pos_tag_sents_equals_jax():
    sents = [jtext.tokenize(s.lower()) for s in SENTENCES] + [
        _lexicon_words(), synthetic.WORDS,
        ["quickly", "beautiful", "runs", "sleeps", "walked", "12:30", "..."]]
    assert ttext.pos_tag_sents(sents) == jtext.pos_tag_sents(sents)
    assert ttext.pos_tag([]) == []


_NO_NLTK = """
import json, sys
sys.modules["nltk"] = None
from insenticap_model_tpu_torch import nltk_text, text
from insenticap_model_tpu_torch.rewards import meteor
sents, words = json.load(sys.stdin)
toks = [text.tokenize(s) for s in sents]
print(json.dumps({"tokens": toks, "tags": text.pos_tag_sents(toks),
                  "stems": [meteor._stem(w) for w in words],
                  "mode": meteor.Meteor().mode,
                  "nltk_tagger": text._nltk_tagger() is not None}))
"""


def test_same_results_without_nltk():
    """In a process where ``import nltk`` fails, as on the card's machine:
    the same tokens, tags and stems, and METEOR* keeps its stem stage."""
    env = dict(os.environ, ISC_WORDNET_DIR="", ISC_METEOR_PARAPHRASE="",
               ISC_METEOR_FUNCTION_WORDS="")
    r = subprocess.run([sys.executable, "-c", _NO_NLTK], cwd=REPO, env=env,
                       input=json.dumps([SENTENCES, STEM_WORDS]),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout)
    toks = [TOKENIZER.tokenize(s) for s in SENTENCES]
    assert got["tokens"] == toks
    assert got["tags"] == [[list(p) for p in s]
                           for s in jtext.pos_tag_sents(toks)]
    assert got["stems"] == [STEMMER.stem(w) for w in STEM_WORDS]
    assert got["mode"].startswith("stages=exact+stem,")
    assert got["nltk_tagger"] is False


def test_nltk_is_imported_only_by_the_optional_lookups():
    """The port's modules import nltk nowhere but inside the two optional
    lookups the JAX package also makes optional: the perceptron tagger
    (``text._nltk_tagger``) and WordNet's data path
    (``meteor.find_wordnet_dir``)."""
    import ast
    allowed = {("text.py", "_nltk_tagger"),
               ("meteor.py", "find_wordnet_dir")}

    def nltk_imports(node):
        return [n for n in ast.walk(node)
                if isinstance(n, (ast.Import, ast.ImportFrom)) and any(
                    name.split(".")[0] == "nltk" for name in (
                        [a.name for a in n.names]
                        if isinstance(n, ast.Import) else [n.module or ""]))]

    where, total = set(), 0
    pkg = os.path.join(REPO, "insenticap_model_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(root, f)).read())
                total += len(nltk_imports(tree))
                for fn in ast.walk(tree):
                    if isinstance(fn, ast.FunctionDef) and nltk_imports(fn):
                        where.add((f, fn.name))
                        total -= len(nltk_imports(fn))
    assert where == allowed and total == 0
