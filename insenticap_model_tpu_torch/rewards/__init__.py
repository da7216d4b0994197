"""Host scorers (the port's copies of the JAX package's ``rewards/``):
CIDEr-D (``ciderd``), BLEU (``bleu``), METEOR* (``meteor``) and the reward
helpers (``rewards``)."""
