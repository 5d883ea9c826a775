"""Device compute ops in PyTorch: scoring, executors, fuzzy matching,
and the hand-written CUDA kernels they launch (ops/kernels.py)."""
