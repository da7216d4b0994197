"""Vocabulary with reference-compatible semantics.

The port's own copy of ``insenticap_model_tpu/vocab.py``'s ``Vocab`` and
``upsample_to_neutral`` (:20-79), plus ``token_ids``
(``insenticap_model_tpu/cli/common.py:52-55``).
The reference builds ``word2idx`` from an ``idx2word`` list with ``<PAD>``
at index 0 followed by ``<UNK>``, ``<SOS>``, ``<EOS>`` (reference
preprocess.py:276, train_xe.py:76-78), and tokenizes with the idiom
``word2idx.get(w, None) or word2idx['<UNK>']``, which maps any word at
index 0 to UNK because 0 is falsy; index 0 is ``<PAD>``, so this is benign,
and it is reproduced so that id streams match.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

from .models.captioner import TokenIds

PAD_TOKEN = "<PAD>"
UNK_TOKEN = "<UNK>"
SOS_TOKEN = "<SOS>"
EOS_TOKEN = "<EOS>"


class Vocab:
    def __init__(self, idx2word: Sequence[str]):
        self.idx2word: List[str] = list(idx2word)
        self.word2idx: Dict[str, int] = {w: i for i, w in
                                         enumerate(self.idx2word)}
        self.pad_id = self.idx2word.index(PAD_TOKEN)
        self.unk_id = self.idx2word.index(UNK_TOKEN)
        # reference quirk (models/captioner.py:127-128): both sos_id and
        # eos_id are gated on '<SOS>' being present
        self.sos_id = (self.idx2word.index(SOS_TOKEN)
                       if SOS_TOKEN in self.word2idx else self.pad_id)
        self.eos_id = (self.idx2word.index(EOS_TOKEN)
                       if SOS_TOKEN in self.word2idx else self.pad_id)

    def __len__(self) -> int:
        return len(self.idx2word)

    def word_to_id(self, w: str) -> int:
        """The reference's falsy-zero get-or-UNK (train_xe.py:89)."""
        return self.word2idx.get(w, None) or self.unk_id

    def encode_caption(self, words: Iterable[str]) -> List[int]:
        """SOS + ids + EOS (reference train_xe.py:86-91)."""
        return ([self.sos_id]
                + [self.word_to_id(w) for w in words]
                + [self.eos_id])

    def encode_strict(self, words: Iterable[str]) -> List[int]:
        """Direct lookup, KeyError on OOV (reference train_xe.py:97-99)."""
        return [self.word2idx[w] for w in words]

    def encode_filter(self, words: Iterable[str]) -> List[int]:
        """Lookup, silently dropping OOV (reference train_xe.py:116)."""
        return [self.word2idx[w] for w in words if w in self.word2idx]

    def decode(self, ids: Iterable[int], stop_at_eos: bool = True
               ) -> List[str]:
        out = []
        for i in ids:
            i = int(i)
            if stop_at_eos and i == self.eos_id:
                break
            out.append(self.idx2word[i])
        return out

    def decode_to_text(self, ids: Iterable[int]) -> str:
        """Join to a caption string, everything before EOS (reference
        models/captioner.py:417-418)."""
        return " ".join(self.decode(ids, stop_at_eos=True))


def token_ids(vocab: Vocab, sentiment_categories) -> TokenIds:
    """The decode's special ids and the neutral label's index."""
    return TokenIds(pad=vocab.pad_id, unk=vocab.unk_id, sos=vocab.sos_id,
                    eos=vocab.eos_id,
                    neutral=list(sentiment_categories).index("neutral"))


def upsample_to_neutral(senti_captions: Dict[str, list]) -> Dict[str, list]:
    """Integer-ratio upsampling of the positive and negative corpora to the
    neutral corpus's size (reference train_xe.py:106-107,
    train_rl.py:147-148)."""
    out = dict(senti_captions)
    n_neu = len(senti_captions["neutral"])
    for senti in ("positive", "negative"):
        lst = senti_captions[senti]
        if lst:
            out[senti] = lst * int(n_neu / len(lst))
    return out
