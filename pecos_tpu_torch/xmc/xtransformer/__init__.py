"""XR-Transformer: an encoder fine-tuned down the label tree, then XR-Linear on [TF-IDF || embedding]."""
from .matcher import TransformerMatcher  # noqa: F401
from .model import XTransformer  # noqa: F401
from .module import MLProblemWithText  # noqa: F401
