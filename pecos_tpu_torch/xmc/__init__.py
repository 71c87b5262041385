"""Extreme multi-label classification (XMC): XR-Linear training and predict in PyTorch."""

from .postprocessor import PostProcessor  # noqa: F401
from .clustering import HierarchicalKMeans, Indexer, LabelEmbeddingFactory  # noqa: F401
from .base import MLProblem, MLModel, HierarchicalMLModel, PredictOnlyHierModel  # noqa: F401
