"""Architecture settings (a copy of ``insenticap_model_tpu.config.Settings``
and ``SENTIMENT_CATEGORIES``; reference opts.py:79-96).

The port keeps its own copy rather than importing the JAX package, so that
it runs where JAX is not installed. ``Settings.to_dict``/``from_dict`` stay
byte-compatible with the JAX package's checkpoint metadata.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

SENTIMENT_CATEGORIES: Tuple[str, ...] = ("positive", "negative", "neutral")


@dataclass(frozen=True)
class Settings:
    """Architecture hyperparameters (reference opts.py:79-96)."""
    word_emb_dim: int = 512
    fc_feat_dim: int = 2048
    att_feat_dim: int = 2048
    feat_emb_dim: int = 512
    dropout_p: float = 0.5
    rnn_hid_dim: int = 512
    att_hid_dim: int = 512
    concept_mid_dim: int = 1024      # reference settings['concept_mid_him']
    sentiment_convs_num: int = 2
    sentiment_fcs_num: int = 2
    # 0 = the standard SentimentDetector; >0 selects the "full" variant
    # (models/sentiment_detector.module_for)
    num_kernels_per_sentiment: int = 0
    # vestigial in the reference (opts.py:92-95); kept for checkpoint
    # metadata compatibility only
    sentiment_feat_dim: int = 14 * 14
    text_cnn_filters: Tuple[int, ...] = (3, 4, 5)
    text_cnn_out_dim: int = 256

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["text_cnn_filters"] = list(d["text_cnn_filters"])
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "Settings":
        d = dict(d)
        # accept the reference's misspelled key
        if "concept_mid_him" in d:
            d["concept_mid_dim"] = d.pop("concept_mid_him")
        if "text_cnn_filters" in d:
            d["text_cnn_filters"] = tuple(d["text_cnn_filters"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
