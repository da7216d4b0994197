"""Data parallelism over ``torch.distributed`` (``mesh``)."""
from . import mesh  # noqa: F401
