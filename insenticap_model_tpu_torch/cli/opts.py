"""argparse front-end producing a ``config.Opts``: the JAX package's
``cli/opts.py`` (flag names, defaults and choices of the reference CLI,
reference opts.py:6-99), plus ``--device``. The architecture ``Settings``
stay a dataclass, overridable through --settings_json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from ..config import Opts, Settings


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    d = Opts()

    # concept detector (reference opts.py:11-15)
    p.add_argument("--concept_lr", type=float, default=d.concept_lr)
    p.add_argument("--concept_bs", type=int, default=d.concept_bs)
    p.add_argument("--concept_resume", type=str, default=d.concept_resume)
    p.add_argument("--concept_epochs", type=int, default=d.concept_epochs)
    p.add_argument("--concept_num_works", type=int,
                   default=d.concept_num_works)
    # sentiment detector (:18-24)
    p.add_argument("--senti_lr", type=float, default=d.senti_lr)
    p.add_argument("--senti_bs", type=int, default=d.senti_bs)
    p.add_argument("--senti_resume", type=str, default=d.senti_resume)
    p.add_argument("--senti_epochs", type=int, default=d.senti_epochs)
    p.add_argument("--senti_num_works", type=int, default=d.senti_num_works)
    p.add_argument("--img_senti_labels", type=str, default=d.img_senti_labels)
    p.add_argument("--sentiment_categories", type=json.loads,
                   default=json.dumps(d.sentiment_categories))
    # xe (:28-38)
    p.add_argument("--xe_lr", type=float, default=d.xe_lr)
    p.add_argument("--xe_bs", type=int, default=d.xe_bs)
    p.add_argument("--xe_resume", type=str, default=d.xe_resume)
    p.add_argument("--xe_epochs", type=int, default=d.xe_epochs)
    p.add_argument("--xe_num_works", type=int, default=d.xe_num_works)
    p.add_argument("--scheduled_sampling_start", type=int,
                   default=d.scheduled_sampling_start)
    p.add_argument("--scheduled_sampling_increase_every", type=int,
                   default=d.scheduled_sampling_increase_every)
    p.add_argument("--scheduled_sampling_increase_prob", type=float,
                   default=d.scheduled_sampling_increase_prob)
    p.add_argument("--scheduled_sampling_max_prob", type=float,
                   default=d.scheduled_sampling_max_prob)
    # rl (:41-49)
    p.add_argument("--rl_lrs", type=json.loads,
                   default=json.dumps(d.rl_lrs))
    p.add_argument("--rl_bs", type=int, default=d.rl_bs)
    p.add_argument("--rl_num_works", type=int, default=d.rl_num_works)
    p.add_argument("--rl_resume", type=str, default=d.rl_resume)
    p.add_argument("--rl_senti_resume", type=str, default=d.rl_senti_resume)
    p.add_argument("--rl_epochs", type=int, default=d.rl_epochs)
    p.add_argument("--rl_fact_times", type=int, default=d.rl_fact_times)
    p.add_argument("--rl_senti_times", type=int, default=d.rl_senti_times)
    p.add_argument("--rl_lm_flag", type=float, default=d.rl_lm_flag)
    p.add_argument("--rl_detector_dtype", type=str,
                   default=d.rl_detector_dtype,
                   choices=["f32", "bf16"])
    # common (:52-63)
    p.add_argument("--dataset_name", type=str, default=d.dataset_name,
                   choices=["coco", "flickr30k"])
    p.add_argument("--corpus_type", type=str, default=d.corpus_type,
                   choices=["part", "full"])
    p.add_argument("--captions_dir", type=str, default=d.captions_dir)
    p.add_argument("--feats_dir", type=str, default=d.feats_dir)
    p.add_argument("--corpus_dir", type=str, default=d.corpus_dir)
    p.add_argument("--checkpoint", type=str, default=d.checkpoint)
    p.add_argument("--result_dir", type=str, default=d.result_dir)
    p.add_argument("--max_seq_len", type=int, default=d.max_seq_len)
    p.add_argument("--num_concepts", type=int, default=d.num_concepts)
    p.add_argument("--num_sentiments", type=int, default=d.num_sentiments)
    p.add_argument("--grad_clip", type=float, default=d.grad_clip)
    # eval/test (:66-75)
    p.add_argument("-e", "--eval_model", type=str, default=d.eval_model)
    p.add_argument("-r", "--result_file", type=str, default=d.result_file)
    p.add_argument("--beam_size", type=int, default=d.beam_size)
    p.add_argument("-t", "--test_model", type=str, default=d.test_model)
    p.add_argument("-i", "--image_file", type=str, default=d.image_file)
    p.add_argument("--resnet101_file", type=str, default=d.resnet101_file)
    # the JAX package's additions (no reference equivalent)
    p.add_argument("--mesh_shape", type=json.loads,
                   default=json.dumps(list(d.mesh_shape)),
                   help="[n]: train data-parallel over n ranks, launched "
                        "by torchrun --nproc_per_node n (every trainer: XE, "
                        "RL and the head stages); a 2-D mesh and the "
                        "other entry points refuse more than one device")
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--settings_json", type=str, default="",
                   help="JSON overrides for architecture Settings")
    p.add_argument("--device", type=str, default=d.device,
                   help="the port's device: cuda (default; refused where "
                        "CUDA is absent) or cpu")
    return p


def parse_opt(argv=None) -> Opts:
    args = build_parser().parse_args(argv)
    known = {f.name for f in dataclasses.fields(Opts)}
    kw = {k: v for k, v in vars(args).items() if k in known}
    kw["mesh_shape"] = tuple(args.mesh_shape)
    settings = Settings()
    if args.settings_json:
        settings = Settings.from_dict({**settings.to_dict(),
                                       **json.loads(args.settings_json)})
    kw["settings"] = settings
    return Opts(**kw)
