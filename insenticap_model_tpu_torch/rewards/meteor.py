"""METEOR* (Meteor 1.5 'en' task, degraded as the JAX package's): the
port's copy of ``insenticap_model_tpu/rewards/meteor.py``.

The same scorer: the match stages exact (w=1.0), Porter stem (w=0.6),
WordNet synonym (w=0.8, where WordNet index files are found:
``ISC_WORDNET_DIR``, else nltk's data path when nltk imports) and
paraphrase (w=0.6, with a table from ``ISC_METEOR_PARAPHRASE`` or
``paraphrase_path=``); the function-word discount; Fmean with α=0.85; the
fragmentation penalty γ·(chunks/m)^β; the max over references; the exact
resolution of the alignment by Meteor's criteria (a pruned lexicographic
search, with Meteor's width-40 beam as the fallback on adversarial
inputs). ``Meteor().name`` is always "METEOR*" and ``Meteor().mode``
records which stages were active (see the JAX module's docstring for the
divergences from the Java Meteor 1.5 and their measured size).

One difference of means, none of result: the JAX package stems with
nltk's ``PorterStemmer`` and falls back to the identity where nltk is
missing, which would drop the stem stage on a host without nltk. The port
stems with its own copy of nltk's stemmer (``nltk_text.PorterStemmer``),
so its scores are the JAX package's as run where nltk is installed. The
JAX module's retired greedy aligner (``_align_greedy``, kept there for an
oracle test) and its word-stage wrapper ``_align`` are not copied.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..nltk_text import PorterStemmer

ALPHA = 0.85   # Meteor 1.5 'en' task parameters
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
W_EXACT = 1.0  # per-stage match weights (Meteor 1.5 'en')
W_STEM = 0.6
W_SYN = 0.8
W_PAR = 0.6


# the port's copy of nltk's PorterStemmer (its default mode), so that the
# stem stage runs where nltk is absent
_STEMMER = PorterStemmer()


def _stem(w: str) -> str:
    return _STEMMER.stem(w)


# Standard English closed-class (function) words: articles, prepositions,
# conjunctions, pronouns, auxiliaries/modals, common particles. Meteor's
# own list is corpus-frequency-derived; this one is a documented stand-in
# (see module docstring).
FUNCTION_WORDS: Set[str] = set("""
a an the this that these those some any each every no
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves themselves who whom whose which what
in on at by for with about against between into through during before
after above below to from up down out off over under again further of
and or but nor so yet if then else when while as because since until
although though whether than
is am are was were be been being do does did doing have has had having
will would shall should may might must can could
not n't there here very too also just only own same such
""".split())


class WordNetSynonyms:
    """Word -> synset-offset sets from WordNet ``index.{pos}`` files
    (WNdb index format: ``lemma pos synset_cnt p_cnt ptr... sense_cnt
    tagsense_cnt offset...``). Two words are synonym-matched when they
    share any (pos, offset)."""

    POS_FILES = ("noun", "verb", "adj", "adv")

    def __init__(self, wn_dir: str):
        from collections import defaultdict
        self.word2synsets: Dict[str, Set[Tuple[str, str]]] = \
            defaultdict(set)
        found = False
        for pos in self.POS_FILES:
            path = os.path.join(wn_dir, f"index.{pos}")
            if not os.path.exists(path):
                continue
            found = True
            with open(path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    if line.startswith(" ") or not line.strip():
                        continue  # license header lines start with spaces
                    parts = line.split()
                    try:
                        synset_cnt = int(parts[2])
                        p_cnt = int(parts[3])
                    except (IndexError, ValueError):
                        continue
                    offsets = parts[4 + p_cnt + 2:4 + p_cnt + 2 + synset_cnt]
                    self.word2synsets[parts[0]].update(
                        (pos, o) for o in offsets)
        if not found:
            raise FileNotFoundError(f"no WordNet index files in {wn_dir}")
        self.word2synsets = dict(self.word2synsets)

    def are_synonyms(self, a: str, b: str) -> bool:
        sa = self.word2synsets.get(a)
        if not sa:
            return False
        sb = self.word2synsets.get(b)
        return bool(sb) and not sa.isdisjoint(sb)


class ParaphraseTable:
    """Phrase-pair table for the Meteor paraphrase stage (w=0.6).

    ``lookup(phrase_tuple)`` returns the set of phrase tuples it
    paraphrases to; pairs are stored symmetrically (Meteor treats the
    table as an undirected phrase relation). Accepted line formats,
    auto-detected per line, plain or gzip (``.gz``):

      * ``phrase ||| paraphrase`` — PPDB-style; when a leading
        ``[LHS]`` nonterminal field is present (full PPDB), the two
        fields after it are taken and trailing feature/alignment
        fields are ignored;
      * ``phrase<TAB>paraphrase``;
      * neither separator: consecutive lines are (phrase, paraphrase)
        pairs — the Meteor-1.5 ``paraphrase-en`` layout.
    """

    MAX_PHRASE_LEN = 6  # spans longer than any real table entry

    def __init__(self, path: str):
        self.table: Dict[Tuple[str, ...], Set[Tuple[str, ...]]] = {}
        self.max_len = 1
        opener = __import__("gzip").open if path.endswith(".gz") else open
        pending: Optional[Tuple[str, ...]] = None
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if "|||" in line:
                    fields = [x.strip() for x in line.split("|||")]
                    if fields[0].startswith("[") and len(fields) >= 3:
                        a, b = fields[1], fields[2]
                    else:
                        a, b = fields[0], fields[1]
                    self._add(a, b)
                elif "\t" in line:
                    a, b = line.split("\t")[:2]
                    self._add(a, b)
                elif pending is None:
                    pending = tuple(line.split())
                else:
                    self._add_tuples(pending, tuple(line.split()))
                    pending = None
        if not self.table:
            raise ValueError(f"no paraphrase pairs parsed from {path}")

    def _add(self, a: str, b: str) -> None:
        self._add_tuples(tuple(a.split()), tuple(b.split()))

    def _add_tuples(self, ta: Tuple[str, ...], tb: Tuple[str, ...]) -> None:
        if not ta or not tb or ta == tb:
            return
        if max(len(ta), len(tb)) > self.MAX_PHRASE_LEN:
            return
        self.table.setdefault(ta, set()).add(tb)
        self.table.setdefault(tb, set()).add(ta)
        self.max_len = max(self.max_len, len(ta), len(tb))

    def lookup(self, phrase: Tuple[str, ...]) -> Set[Tuple[str, ...]]:
        return self.table.get(phrase, _EMPTY_SET)


_EMPTY_SET: Set[Tuple[str, ...]] = frozenset()  # type: ignore[assignment]


def find_paraphrase_path() -> Optional[str]:
    """ISC_METEOR_PARAPHRASE, if it points at a readable file."""
    cand = os.environ.get("ISC_METEOR_PARAPHRASE")
    return cand if cand and os.path.isfile(cand) else None


def find_function_words_path() -> Optional[str]:
    """ISC_METEOR_FUNCTION_WORDS, if it points at a readable file."""
    cand = os.environ.get("ISC_METEOR_FUNCTION_WORDS")
    return cand if cand and os.path.isfile(cand) else None


def load_function_words(path: str) -> Set[str]:
    """One word per line ('#' comments allowed) — the format of Meteor
    1.5's own ``function.words`` resource, so the official file drops in
    unchanged when available."""
    words: Set[str] = set()
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            w = line.strip()
            if w and not w.startswith("#"):
                words.add(w.lower())
    if not words:
        raise ValueError(f"no function words parsed from {path}")
    return words


def derive_function_words(token_seqs, min_rel_freq: float = 1e-3
                          ) -> Set[str]:
    """Build a function-word list by Meteor's OWN definition: every word
    whose relative frequency in a monolingual corpus exceeds 10^-3
    (Denkowski & Lavie 2014 §3 — their ``function.words`` was derived
    this way from newswire text). Given the training-caption corpus this
    reproduces the derivation procedure, if not the exact newswire list;
    write the result out and point ISC_METEOR_FUNCTION_WORDS at it so
    runs on different hosts score identically.

    token_seqs: iterable of token sequences (lowercased by caller or
    not — counting is case-folded)."""
    from collections import Counter
    counts: Counter = Counter()
    total = 0
    for seq in token_seqs:
        for w in seq:
            counts[w.lower()] += 1
            total += 1
    if total == 0:
        return set()
    return {w for w, c in counts.items() if c / total > min_rel_freq}


def find_wordnet_dir() -> Optional[str]:
    """ISC_WORDNET_DIR, else <any nltk_data path>/corpora/wordnet."""
    cand = os.environ.get("ISC_WORDNET_DIR")
    if cand and os.path.isdir(cand):
        return cand
    try:
        import nltk.data
        roots = list(nltk.data.path)
    except Exception:  # pragma: no cover
        roots = []
    for root in roots:
        d = os.path.join(root, "corpora", "wordnet")
        if os.path.isfile(os.path.join(d, "index.noun")):
            return d
    return None


def _candidate_matches(hyp: Sequence[str], ref: Sequence[str],
                       hyp_stems: Sequence[str], ref_stems: Sequence[str],
                       wordnet: Optional[WordNetSynonyms]
                       ) -> List[List[Tuple[int, float]]]:
    """Per-hyp-position candidate list [(ref_j, stage_weight)]. When a
    pair matches several stages, module precedence applies (exact, then
    stem, then synonym — Meteor's matcher keeps the earliest module)."""
    cand: List[List[Tuple[int, float]]] = [[] for _ in hyp]
    for i, (w, s) in enumerate(zip(hyp, hyp_stems)):
        row = cand[i]
        for j, (rw, rs) in enumerate(zip(ref, ref_stems)):
            if w == rw:
                row.append((j, W_EXACT))
            elif s == rs:
                row.append((j, W_STEM))
            elif wordnet is not None and wordnet.are_synonyms(w, rw):
                row.append((j, W_SYN))
    return cand


# DFS node budget before falling back to the beam resolver. Natural
# caption pairs resolve in <1k nodes; only adversarial repetition
# patterns approach this.
_MAX_NODES = 200_000
_BEAM = 40  # Meteor 1.5's own resolver beam width

# span match: (hyp_len, ref_start, ref_len, stage_weight), listed per
# hyp start position; a resolved match adds the hyp start index up front
_Span = Tuple[int, int, int, float]


def _candidate_spans(hyp: Sequence[str], ref: Sequence[str],
                     hyp_stems: Sequence[str], ref_stems: Sequence[str],
                     wordnet: Optional[WordNetSynonyms],
                     paraphrases: Optional[ParaphraseTable]
                     ) -> List[List[_Span]]:
    """Per-hyp-start candidate spans. Word stages produce 1:1 spans;
    the paraphrase stage produces phrase spans. Module precedence: a
    1:1 pair already matched by an earlier stage keeps that stage's
    weight (paraphrase is the last module)."""
    word = _candidate_matches(hyp, ref, hyp_stems, ref_stems, wordnet)
    cand: List[List[_Span]] = [[(1, j, 1, w) for j, w in row]
                               for row in word]
    if paraphrases is not None:
        # all ref spans up to the table's max phrase length, by content
        ref_spans: Dict[Tuple[str, ...], List[int]] = {}
        for j in range(len(ref)):
            for rl in range(1, min(paraphrases.max_len,
                                   len(ref) - j) + 1):
                ref_spans.setdefault(tuple(ref[j:j + rl]), []).append(j)
        for i in range(len(hyp)):
            word_matched = {j for j, _ in word[i]}
            for hl in range(1, min(paraphrases.max_len,
                                   len(hyp) - i) + 1):
                for para in paraphrases.lookup(tuple(hyp[i:i + hl])):
                    rl = len(para)
                    for j in ref_spans.get(para, ()):
                        if hl == 1 and rl == 1 and j in word_matched:
                            continue  # earlier module wins for this pair
                        cand[i].append((hl, j, rl, W_PAR))
    return cand


def _align_spans(cand: List[List[_Span]], n: int
                 ) -> List[Tuple[int, int, int, int, float]]:
    """Meteor 1.5 alignment resolution (Denkowski & Lavie 2014 §2.1),
    solved EXACTLY over span matches: among one-to-one match sets
    (every word covered at most once on each side), lexicographically
    (1) maximize covered words summed over both sentences, (2) minimize
    chunks, (3) minimize the sum of |hyp_start − ref_start| offsets.
    Pruned DFS over hyp start positions — all three key components are
    monotone along a path, so componentwise lower bounds prune
    lexicographically. Falls back to a Meteor-style width-40 beam over
    the same key if the node budget is hit (adversarial inputs only).
    Returns [(hyp_i, hyp_len, ref_j, ref_len, stage_weight)] sorted by
    hyp index."""
    # ub[i]: max covered-word total addable from hyp position i onward,
    # ignoring ref conflicts (valid upper bound for pruning).
    ub = [0] * (n + 1)
    for i in range(n - 1, -1, -1):
        ub[i] = ub[i + 1]
        for hl, _, rl, _w in cand[i]:
            ub[i] = max(ub[i], hl + rl + ub[i + hl])

    best_key = (1, 0, 0)  # worse than any real alignment (cov >= 0)
    best_matches: List[Tuple[int, int, int, int, float]] = []
    nodes = 0

    # state: (i, used ref bitmask, cov, chunks, dist,
    #         last match end (hyp_end, ref_end) or None)
    def dfs(i, used, cov, chunks, dist, last, matches):
        nonlocal best_key, best_matches, nodes
        nodes += 1
        if nodes > _MAX_NODES:
            raise _NodeBudget()
        if i == n:
            key = (-cov, chunks, dist)
            if key < best_key:
                best_key = key
                best_matches = list(matches)
            return
        lb = (-(cov + ub[i]), chunks, dist)
        if lb >= best_key:
            return
        # try matches first (better incumbents earlier); prefer the
        # chunk-extending candidate, then bigger spans, small offsets
        row = cand[i]
        if row:
            chain_j = (last[1] + 1 if last is not None and last[0] == i - 1
                       else -10**9)
            order = sorted(
                range(len(row)),
                key=lambda k: (row[k][1] != chain_j,
                               -(row[k][0] + row[k][2]),
                               abs(i - row[k][1])))
            for k in order:
                hl, j, rl, w = row[k]
                mask = ((1 << rl) - 1) << j
                if used & mask:
                    continue
                nchunks = chunks + (0 if (last is not None
                                          and last == (i - 1, j - 1))
                                    else 1)
                matches.append((i, hl, j, rl, w))
                dfs(i + hl, used | mask, cov + hl + rl, nchunks,
                    dist + abs(i - j), (i + hl - 1, j + rl - 1), matches)
                matches.pop()
        dfs(i + 1, used, cov, chunks, dist, last, matches)

    try:
        dfs(0, 0, 0, 0, 0, None, [])
        return best_matches
    except _NodeBudget:
        return _align_spans_beam(cand, n)


class _NodeBudget(Exception):
    pass


def _align_spans_beam(cand: List[List[_Span]], n: int
                      ) -> List[Tuple[int, int, int, int, float]]:
    """Width-40 beam over the same lexicographic key — what the Java
    Meteor resolver itself does; only reached on adversarial inputs."""
    # state: (key, next hyp position, used, last, matches)
    states = [((0, 0, 0), 0, 0, None, [])]
    for i in range(n):
        nxt = []
        for key, pos, used, last, matches in states:
            if pos > i:      # a span already covers position i
                nxt.append((key, pos, used, last, matches))
                continue
            negc, chunks, dist = key
            nxt.append((key, i + 1, used, last, matches))
            for hl, j, rl, w in cand[i]:
                mask = ((1 << rl) - 1) << j
                if used & mask:
                    continue
                nchunks = chunks + (0 if (last is not None
                                          and last == (i - 1, j - 1))
                                    else 1)
                nxt.append(((negc - hl - rl, nchunks, dist + abs(i - j)),
                            i + hl, used | mask,
                            (i + hl - 1, j + rl - 1),
                            matches + [(i, hl, j, rl, w)]))
        nxt.sort(key=lambda s: s[0])
        states = nxt[:_BEAM]
    return states[0][4]


def _content_weight(w: str, function_words: Optional[Set[str]]) -> float:
    if function_words is None:
        return 1.0
    return (1.0 - DELTA) if w in function_words else DELTA


def score_sentence(hyp: Sequence[str], refs: List[Sequence[str]],
                   wordnet: Optional[WordNetSynonyms] = None,
                   function_words: Optional[Set[str]] = FUNCTION_WORDS,
                   paraphrases: Optional[ParaphraseTable] = None
                   ) -> float:
    hyp = list(hyp)
    hyp_stems = [_stem(w) for w in hyp]  # stem once, not per pair
    hyp_wsum = sum(_content_weight(w, function_words) for w in hyp)
    best = 0.0
    for ref in refs:
        ref = list(ref)
        if not hyp or not ref:
            continue
        cand = _candidate_spans(hyp, ref, hyp_stems,
                                [_stem(w) for w in ref],
                                wordnet, paraphrases)
        align = _align_spans(cand, len(hyp))
        if not align:
            continue
        # covered words per side; weighted P/R: stage weight ×
        # function-word discount over every covered word of that side
        m_hyp = sum(hl for _, hl, _, _, _ in align)
        m_ref = sum(rl for _, _, _, rl, _ in align)
        wp = sum(w * _content_weight(hyp[i + k], function_words)
                 for i, hl, _, _, w in align for k in range(hl))
        wr = sum(w * _content_weight(ref[j + k], function_words)
                 for _, _, j, rl, w in align for k in range(rl))
        ref_wsum = sum(_content_weight(w, function_words) for w in ref)
        if hyp_wsum == 0 or ref_wsum == 0:
            continue
        p = wp / hyp_wsum
        r = wr / ref_wsum
        if p == 0 or r == 0:
            continue
        fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        chunks = 1
        for (i0, hl0, j0, rl0, _), (i1, _, j1, _, _) in zip(align,
                                                            align[1:]):
            if not (i1 == i0 + hl0 and j1 == j0 + rl0):
                chunks += 1
        # Meteor 1.5 averages the two sides' coverage for the
        # fragmentation denominator (= the match count when all
        # matches are 1:1 word matches)
        penalty = GAMMA * (chunks / ((m_hyp + m_ref) / 2.0)) ** BETA
        best = max(best, fmean * (1.0 - penalty))
    return best


class Meteor:
    """coco-caption-shaped API: compute_score(gts, res) -> (mean, scores).

    wordnet_dir: explicit WordNet db dir; by default auto-discovered via
    find_wordnet_dir(). paraphrase_path: a ParaphraseTable file (see
    that class for formats); by default ISC_METEOR_PARAPHRASE. ``name``
    is ALWAYS "METEOR*": the function-word list is a stand-in and the
    official paraphrase table is not redistributable, so values are not
    interchangeable with coco-caption METEOR (advisor r3) — tables must
    not invite that comparison. ``mode`` records which stages were
    active so results from different hosts are comparable."""

    _DEFAULT_FW: Set[str] = frozenset({"__default__"})  # sentinel

    def __init__(self, wordnet_dir: Optional[str] = None,
                 function_words: Optional[Set[str]] = _DEFAULT_FW,
                 paraphrase_path: Optional[str] = None):
        d = wordnet_dir or find_wordnet_dir()
        self.wordnet = WordNetSynonyms(d) if d else None
        if function_words is Meteor._DEFAULT_FW:
            fwp = find_function_words_path()
            function_words = (load_function_words(fwp) if fwp
                              else FUNCTION_WORDS)
            self._fw_source = "file" if fwp else "builtin"
        else:
            self._fw_source = ("none" if function_words is None else
                               "builtin" if function_words is FUNCTION_WORDS
                               else "custom")
        self.function_words = function_words
        p = paraphrase_path or find_paraphrase_path()
        self.paraphrases = ParaphraseTable(p) if p else None

    @property
    def name(self) -> str:
        return "METEOR*"

    @property
    def mode(self) -> str:
        """One-line provenance: active match stages + word-list source."""
        stages = ("exact+stem"
                  + ("+syn" if self.wordnet is not None else "")
                  + ("+para" if self.paraphrases is not None else ""))
        return (f"stages={stages}, function_words={self._fw_source}, "
                f"aligner=exact-meteor-criteria")

    def compute_score(self, gts: Dict, res: List[Dict]):
        scores = [score_sentence(item["caption"][0],
                                 gts[item["image_id"]],
                                 wordnet=self.wordnet,
                                 function_words=self.function_words,
                                 paraphrases=self.paraphrases)
                  for item in res]
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores
