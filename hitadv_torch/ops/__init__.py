"""Geometry ops and the hand-written CUDA kernels of the main path."""
