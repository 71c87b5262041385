from .module import dist_fine_tune  # noqa: F401
