"""Scoring, ranking and the CUDA stage-1 kernels."""
