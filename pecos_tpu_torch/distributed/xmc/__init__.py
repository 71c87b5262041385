from .base import DistClusterChain, DistClustering  # noqa: F401
