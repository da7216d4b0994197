"""Two-tier configuration: the run flags ``Opts`` and the architecture
``Settings`` (copies of ``insenticap_model_tpu/config.py``'s, with
``SENTIMENT_CATEGORIES``; reference opts.py:10-97).

The port keeps its own copy rather than importing the JAX package, so that
it runs where JAX is not installed. ``Settings.to_dict``/``from_dict`` stay
byte-compatible with the JAX package's checkpoint metadata. ``Opts`` has
the JAX package's fields and defaults plus ``device``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

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


@dataclass
class Opts:
    """Run flags (reference opts.py:10-75; the JAX package's
    ``config.Opts``, :62-157), plus ``device``."""
    # concept detector
    concept_lr: float = 4e-4
    concept_bs: int = 80
    concept_resume: str = ""
    concept_epochs: int = 40
    concept_num_works: int = 2
    # sentiment detector
    senti_lr: float = 4e-4
    senti_bs: int = 80
    senti_resume: str = ""
    senti_epochs: int = 30
    senti_num_works: int = 2
    img_senti_labels: str = "./data/captions/img_senti_labels.json"
    sentiment_categories: List[str] = field(
        default_factory=lambda: list(SENTIMENT_CATEGORIES))
    # xe
    xe_lr: float = 4e-4
    xe_bs: int = 20
    xe_resume: str = ""
    xe_epochs: int = 40
    xe_num_works: int = 2
    scheduled_sampling_start: int = 0
    scheduled_sampling_increase_every: int = 4
    scheduled_sampling_increase_prob: float = 0.05
    scheduled_sampling_max_prob: float = 0.25
    # rl
    rl_lrs: Dict[str, float] = field(default_factory=lambda: {"cap_lr": 4e-5})
    rl_bs: int = 40
    rl_num_works: int = 2
    rl_resume: str = ""
    rl_senti_resume: str = "checkpoint/sentiment/model-10.pth"
    rl_epochs: int = 40
    rl_fact_times: int = 1
    rl_senti_times: int = 0
    rl_lm_flag: float = 0.0
    rl_detector_dtype: str = "f32"               # "f32" | "bf16"
    # common
    dataset_name: str = "coco"
    corpus_type: str = "part"
    captions_dir: str = "./data/captions"
    feats_dir: str = "./data/features"
    corpus_dir: str = "./data/corpus"
    checkpoint: str = "./checkpoint/"
    result_dir: str = "./result/"
    max_seq_len: int = 16
    num_concepts: int = 5
    num_sentiments: int = 10
    grad_clip: float = 0.1
    # eval / test
    eval_model: str = ""
    result_file: str = ""
    beam_size: int = 3
    test_model: str = ""
    image_file: str = ""
    resnet101_file: str = "./data/pre_models/resnet101.pth"
    # the JAX package's additions
    mesh_shape: Tuple[int, ...] = ()
    compute_dtype: str = "float32"               # "float32" | "bfloat16"
    seed: int = 0
    # the port's: the card unless the caller asks for the CPU
    device: str = "cuda"

    settings: Settings = field(default_factory=Settings)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["settings"] = self.settings.to_dict()
        d["mesh_shape"] = list(self.mesh_shape)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Opts":
        d = json.loads(s)
        d["settings"] = Settings.from_dict(d.get("settings", {}))
        d["mesh_shape"] = tuple(d.get("mesh_shape", ()))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
