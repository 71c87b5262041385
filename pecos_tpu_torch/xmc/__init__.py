"""Extreme multi-label classification (XMC): XR-Linear predict in PyTorch."""

from .postprocessor import PostProcessor  # noqa: F401
from .base import MLModel, HierarchicalMLModel, PredictOnlyHierModel  # noqa: F401
