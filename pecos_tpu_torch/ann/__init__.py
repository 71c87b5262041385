"""Approximate nearest neighbor search in PyTorch: HNSW (+ PQ4) and PairwiseANN."""

from .hnsw.model import HNSW  # noqa: F401
