from .model import XLinearModel  # noqa: F401
