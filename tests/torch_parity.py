"""Shared helpers of the tests that hold the PyTorch port against the JAX
package on the CPU: the same seeded numpy inputs and the same weights
(made by the JAX package's initialisers, carried over with
``convert.from_jax_numpy``) go through both."""
import numpy as np
import torch

import jax

from insenticap_model_tpu.models import captioner as jcap
from insenticap_model_tpu.models import sentiment_detector as jsd
from insenticap_model_tpu_torch import convert
from insenticap_model_tpu_torch.config import Settings
from insenticap_model_tpu_torch.models import captioner as tcap

V = 24                                   # the conftest vocab's size
JIDS = jcap.TokenIds(pad=0, unk=1, sos=2, eos=3, neutral=2)
TIDS = tcap.TokenIds(*JIDS)


def port_settings(jax_settings) -> Settings:
    return Settings.from_dict(jax_settings.to_dict())


def to_port(jax_tree):
    """JAX pytree -> the port's params on the CPU, through numpy."""
    return convert.from_jax_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jax_tree),
                                  device="cpu")


def captioner_params(settings, seed=0, eos_bias=0.0):
    """JAX captioner params (+ ``eos_bias`` on the EOS logit, so that
    captions end early) and their port copy."""
    p = jcap.init_params(jax.random.PRNGKey(seed), V, 3, settings)
    if eos_bias:
        cls = dict(p["classifier"])
        cls["b"] = cls["b"].at[JIDS.eos].add(eos_bias)
        p = dict(p, classifier=cls)
    return p, to_port(p)


def detector_params(settings, seed=1, scale=1.0):
    """JAX detector params, the fcs scaled by ``scale`` so that some
    images clear the confidence threshold, and their port copy."""
    p = jsd.init_params(jax.random.PRNGKey(seed), 3, settings)
    p = dict(p, fcs=[{"w": f["w"] * scale, "b": f["b"] * scale}
                     for f in p["fcs"]])
    return p, to_port(p)


def features(settings, bs, seed, m=5):
    """(fc, att, sentis) as numpy: att non-negative like a ResNet grid."""
    g = np.random.default_rng(seed)
    fc = g.random((bs, settings.fc_feat_dim), np.float32)
    att = g.random((bs, 14, 14, settings.att_feat_dim), np.float32)
    sentis = g.integers(4, V, size=(bs, m)).astype(np.int32)
    return fc, att, sentis


def t(a):
    """numpy -> CPU tensor (int32 ids stay int32)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def n(x):
    """Tensor or JAX array -> float64/int numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x)
