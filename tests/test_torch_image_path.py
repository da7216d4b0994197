"""The image path as a whole, the port against the JAX package on the CPU,
f32: uint8 images -> ResNet-101 at full depth -> concept top-5 -> ranked
sentiment words -> detect + beam decode. The port runs its EncodeBatcher
(raw-uint8 encoder, f32 concept scoring) and then
``inference.detect_and_decode``; the JAX package runs
``encoder.forward_raw_batch``, ``concept_detector.sample``,
``cli.common.senti_word_ids`` and ``inference.detect_and_decode``. The
captioner and detector are at the test widths with 2048-d features.
Required: identical concept ids, labels and top-beam tokens; top-beam
scores within 1e-4 (sums of f32 log-probs in another order)."""
import dataclasses
import threading

import numpy as np
import torch

import jax
import jax.numpy as jnp

from insenticap_model_tpu import inference as jinf
from insenticap_model_tpu.cli import common as jcommon
from insenticap_model_tpu.models import concept_detector as jcpt
from insenticap_model_tpu.models import encoder as jenc
from insenticap_model_tpu.vocab import Vocab as JVocab

from insenticap_model_tpu_torch import inference as tinf
from insenticap_model_tpu_torch.cli import common as tcommon
from insenticap_model_tpu_torch.models import encoder as tenc
from insenticap_model_tpu_torch.serving.encode import (EncodeBatcher,
                                                       make_cpt_apply)
from insenticap_model_tpu_torch.vocab import Vocab

from torch_parity import (JIDS, TIDS, captioner_params, detector_params,
                          encoder_params, n, port_settings, to_port)

N_CPT = 40
K = 5
M = 5
T = 10


def test_images_to_captions_match_jax(settings, vocab):
    s = dataclasses.replace(settings, fc_feat_dim=2048, att_feat_dim=2048)
    jep, tep = encoder_params(2)
    # random ResNet features differ little between images: fc1 scaled up
    # so that the concept ranking follows the image
    jcp = jcpt.init_params(jax.random.PRNGKey(7), N_CPT, s)
    jcp = dict(jcp, fc1={"w": jcp["fc1"]["w"] * 5, "b": jcp["fc1"]["b"]})
    tcp = to_port(jcp)
    jcap_p, tcap_p = captioner_params(s, seed=9, eos_bias=0.1)
    jdet_p, tdet_p = detector_params(s, seed=4, scale=30.0)
    idx2concept = [f"c{i}" for i in range(N_CPT)]
    g = np.random.default_rng(8)
    table = {c: [[f"w{int(w)}", float(sc)] for w, sc in zip(
        g.integers(0, 20, 4), g.random(4))] for c in idx2concept}
    imgs = g.integers(0, 256, size=(3, 64, 64, 3)).astype(np.uint8)
    imgs[1] //= 4                                   # dark
    imgs[2] = 255 - imgs[2] // 3                    # bright

    # the port: encode stage (three rows padded to the 4-bucket), then the
    # serving step
    b = EncodeBatcher(lambda x: tenc.forward_raw_batch(tep, x),
                      make_cpt_apply(tcp, K),
                      fc_dim=2048, shape_buckets=((64, 64),),
                      batch_buckets=(1, 4), max_wait_s=0.5, device="cpu")
    try:
        enc = [None] * 3
        threads = [threading.Thread(target=lambda i=i: enc.__setitem__(
            i, b.submit_image(imgs[i], timeout=300))) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert b.stats()["requests"] == 3
    finally:
        b.close()
    t_top = np.stack([e[2] for e in enc])
    t_sentis = np.stack([tcommon.senti_word_ids(
        [idx2concept[k] for k in top], table, Vocab(vocab.idx2word), M)
        for top in t_top])
    t_seqs, t_scores, t_labels = tinf.detect_and_decode(
        tinf.ServingParams(tcap_p, tdet_p),
        torch.from_numpy(np.stack([e[0] for e in enc])),
        torch.from_numpy(np.stack([e[1] for e in enc])),
        torch.from_numpy(t_sentis), settings=port_settings(s), ids=TIDS,
        max_seq_len=T)

    # the JAX package's chain
    jfc, jatt = jenc.forward_raw_batch(jep, jnp.asarray(imgs))
    _, j_top, _ = jcpt.sample(jcp, jfc, K)
    j_sentis = np.stack([jcommon.senti_word_ids(
        [idx2concept[k] for k in top], table, JVocab(vocab.idx2word), M)
        for top in np.asarray(j_top)])
    j_seqs, j_scores, j_labels = jinf.detect_and_decode(
        jinf.ServingParams(jcap_p, jdet_p), jfc, jatt,
        jnp.asarray(j_sentis), settings=s, ids=JIDS, max_seq_len=T)

    np.testing.assert_array_equal(t_top, np.asarray(j_top))
    np.testing.assert_array_equal(t_sentis, j_sentis)
    assert (t_sentis != vocab.pad_id).any()
    np.testing.assert_array_equal(n(t_labels), n(j_labels))
    np.testing.assert_array_equal(n(t_seqs)[:, 0], n(j_seqs)[:, 0])
    np.testing.assert_allclose(n(t_scores)[:, 0], n(j_scores)[:, 0],
                               rtol=1e-4, atol=1e-4)
    assert t_seqs.shape == (3, 3, T)
    # the images' own concepts and captions came through
    assert len({tuple(r) for r in t_top}) > 1
    assert len({tuple(r) for r in n(t_seqs)[:, 0]}) > 1
