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
from insenticap_model_tpu_torch.utils.tolerance import bf16_ulp_error

V = 24                                  # the conftest vocab's size
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


def resnet_state_dict(seed=0):
    """A torchvision-style ResNet-101 state dict of numpy arrays:
    kaiming-normal (fan-out) convs, BatchNorm statistics drawn around the
    identity, and each residual branch's last BatchNorm scaled by 0.2 so
    that the features stay O(1) through 101 layers."""
    from insenticap_model_tpu.models import encoder as jenc
    g = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = (g.standard_normal((cout, cin, k, k))
                                * np.sqrt(2.0 / (k * k * cout))
                                ).astype(np.float32)

    def bn(name, c, scale=1.0):
        sd[name + ".weight"] = (scale * g.uniform(0.9, 1.1, c)
                                ).astype(np.float32)
        sd[name + ".bias"] = g.normal(0, 0.05, c).astype(np.float32)
        sd[name + ".running_mean"] = g.normal(0, 0.05, c).astype(np.float32)
        sd[name + ".running_var"] = g.uniform(0.5, 1.5, c).astype(np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (nblocks, mid) in enumerate(zip(jenc.LAYERS, jenc.MIDS)):
        cout = mid * jenc.EXPANSION
        for b in range(nblocks):
            base = f"layer{li + 1}.{b}"
            conv(base + ".conv1", mid, cin, 1)
            bn(base + ".bn1", mid)
            conv(base + ".conv2", mid, mid, 3)
            bn(base + ".bn2", mid)
            conv(base + ".conv3", cout, mid, 1)
            bn(base + ".bn3", cout, 0.2)
            if b == 0:
                conv(base + ".downsample.0", cout, cin, 1)
                bn(base + ".downsample.1", cout)
            cin = cout
    return sd


def encoder_params(seed=0):
    """JAX encoder params (through the JAX package's
    ``convert_torch_state_dict``) and their port copy."""
    from insenticap_model_tpu.models import encoder as jenc
    p = jenc.convert_torch_state_dict(resnet_state_dict(seed))
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


def assert_within_bf16_ulp(got, want, floor_frac=1e-3):
    """|got - want| <= one bf16 ulp of want everywhere, the ulp taken at no
    less than floor_frac of max|want| (``utils.tolerance.bf16_ulp_error``)."""
    err, ulps = bf16_ulp_error(torch.tensor(np.asarray(n(got), np.float64)),
                               torch.tensor(np.asarray(n(want), np.float64)),
                               floor_frac)
    assert ulps <= 1, (ulps, err)


def caption_batches(settings, bs, seed, maxlen=8, vocab=V, n_att=9):
    """(batch, scs_batch) of numpy arrays for the XE step: captions SOS ...
    EOS of lengths 2..maxlen (the length counts the tokens after SOS), an
    att grid of n_att positions, 5 concepts, 6 sentiment words, labels."""
    g = np.random.default_rng(seed)

    def caps_lengths():
        caps = np.zeros((bs, maxlen + 1), np.int32)
        lengths = []
        for i in range(bs):
            L = int(g.integers(2, maxlen + 1))
            caps[i, 0] = JIDS.sos
            caps[i, 1:L] = g.integers(4, vocab, size=L - 1)
            caps[i, L] = JIDS.eos
            lengths.append(L)
        return caps, np.asarray(lengths, np.int32)

    caps, lengths = caps_lengths()
    batch = {
        "fc": g.normal(size=(bs, settings.fc_feat_dim)).astype(np.float32),
        "att": g.normal(size=(bs, n_att, settings.att_feat_dim)).astype(
            np.float32),
        "caps": caps, "lengths": lengths,
        "cpts": g.integers(4, vocab, size=(bs, 5)).astype(np.int32)}
    scaps, slengths = caps_lengths()
    scs = {"caps": scaps, "lengths": slengths,
           "cpts": g.integers(4, vocab, size=(bs, 5)).astype(np.int32),
           "sentis": g.integers(4, vocab, size=(bs, 6)).astype(np.int32),
           "senti_labels": g.integers(0, 3, size=(bs,)).astype(np.int32)}
    return batch, scs


def jax_numpy(tree):
    """The port's params -> the JAX package's layout as numpy, flattened
    in JAX's order: [(path, array)]."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        convert.to_jax_numpy(tree))
    return [(jax.tree_util.keystr(p), np.asarray(a)) for p, a in flat]


def jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(a)) for p, a in flat]


def classifier_params(settings, seed=1):
    """JAX sentence-classifier params and their port copy."""
    from insenticap_model_tpu.models import sent_senti_cls as jss
    p = jss.init_params(jax.random.PRNGKey(seed), V, 3, settings)
    return p, to_port(p)


# the captioner's attention-score biases (JAX layout paths): the softmax
# over positions is invariant to them, so their gradient is zero up to
# rounding, and Adam's g / (|g| + eps) turns that rounding into an update
# of up to lr a step in either package
SOFTMAX_INVARIANT = ("['attention']['cont']['att_alpha']['b']",
                     "['attention']['senti']['word_alpha']['b']")


def assert_params_match(port_params, jax_params, steps, lr):
    """Trained params against the JAX package's: within 1e-6 absolute, the
    SOFTMAX_INVARIANT biases within lr * steps."""
    got, want = jax_numpy(port_params), jax_flat(jax_params)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        tol = lr * steps if path in SOFTMAX_INVARIANT else 1e-6
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=path)
