from .model import Text2Text  # noqa: F401
