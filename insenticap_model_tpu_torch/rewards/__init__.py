"""Host reward scorers (the port's copies of the JAX package's
``rewards/ciderd.py`` and ``rewards/rewards.py``)."""
