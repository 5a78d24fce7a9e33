"""Ops on tensors: segment reductions, embedding lookup, the z-embedding
reduce, and the hand-written CUDA kernels behind them."""
