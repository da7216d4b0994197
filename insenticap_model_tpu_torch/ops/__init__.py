"""Beam search and the hand-written CUDA kernels with their plain PyTorch twins."""
