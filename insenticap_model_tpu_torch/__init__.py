"""insenticap_model_tpu_torch — the PyTorch/CUDA port of the sentiment-
controllable captioner, for NVIDIA Hopper (H100).

The JAX package ``insenticap_model_tpu`` beside it is the reference: every
module here keeps the name of its counterpart there, and the tests hold the
two against each other on the CPU. This package imports ``torch`` only;
whatever it needs from the JAX package's host modules it keeps its own copy
of.

Layer map:
  config        — ``Settings`` (architecture), ``Opts`` (run flags) and
                  the sentiment categories
  vocab         — ``Vocab``, the decode's special ids (``token_ids``) and
                  the sentiment corpus's upsampling
  nn            — primitives on plain tensors (linear, embed, lstm_cell,
                  NHWC conv2d, log_softmax, dropout) with torch-default
                  initialisers, and parameter-tree helpers
  convert       — weight bridge from/to the JAX package's numpy pytrees
  training      — ``checkpoint``: reads and writes the JAX package's
                  checkpoint files (its own msgpack codec in
                  ``utils/msgpack.py``), optimizer state included;
                  ``optim``: Adam behind the gradient clamp; ``steps``:
                  the XE train and eval steps
  data          — batch assembly, loaders and the native feature store;
                  ``synthetic`` writes a small artefact tree
  models        — the captioner (decode cell, training forwards,
                  criteria), the sentence classifier, the image-sentiment
                  detector and its "full" variant
                  (``sentiment_detector.module_for``)
  ops           — beam search, the beam-shared attention (v1, v2), the
                  fused classifier top-k and the chained Winograd detector
                  convs, each a hand-written CUDA kernel under ``csrc/``
                  (built at first use by ``ops/_build.py``) with a plain
                  PyTorch twin for CPU tensors
  inference     — ``detect_and_decode``, ``sweep_sentiments`` and the
                  serving callables
  serving       — the dynamic-batching core; ``serving_daemon`` holds the
                  single-device ``DynamicBatcher`` and
                  ``make_batcher_from_checkpoint``
  cli           — entry points: ``serve``, ``caption``, ``train_xe``

Two switches, read at each call as the JAX package reads them:
``ISC_FUSED_TOPK=1`` sends the beam's vocabulary tail through the fused
top-k kernel, ``ISC_ATT_KERNEL=v2`` picks the v2 attention kernel. Both
are off by default.

Entry points take a ``device`` argument that defaults to ``"cuda"`` and
raise when CUDA is absent; pass ``device="cpu"`` to run the plain versions.
"""

__version__ = "0.1.0"
