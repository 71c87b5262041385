from .model import PairwiseANN  # noqa: F401
