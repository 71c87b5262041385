from .vectorizers import Vectorizer, Tfidf  # noqa: F401
from .preprocess import Preprocessor  # noqa: F401
