"""insenticap_model_tpu_torch — the PyTorch/CUDA port of the sentiment-
controllable captioner, for NVIDIA Hopper (H100).

The JAX package ``insenticap_model_tpu`` beside it is the reference: every
module here keeps the name of its counterpart there, and the tests hold the
two against each other on the CPU. This package imports ``torch`` only;
whatever it needs from the JAX package's host modules it keeps its own copy
of.

Layer map (serving slice):
  config        — ``Settings`` (architecture) and the sentiment categories
  nn            — primitives on plain tensors (linear, embed, lstm_cell,
                  NHWC conv2d, log_softmax) with torch-default initialisers
  convert       — weight bridge from/to the JAX package's numpy pytrees
  models        — captioner decode cell, image-sentiment detector
  ops           — beam search, the beam-shared attention and the chained
                  Winograd detector convs, each a hand-written CUDA kernel
                  under ``csrc/`` (built at first use by ``ops/_build.py``)
                  with a plain PyTorch twin for CPU tensors
  inference     — ``detect_and_decode`` and the serving callables
  serving       — the dynamic-batching core; ``serving_daemon`` holds the
                  single-device ``DynamicBatcher``

Entry points take a ``device`` argument that defaults to ``"cuda"`` and
raise when CUDA is absent; pass ``device="cpu"`` to run the plain versions.
"""

__version__ = "0.1.0"
