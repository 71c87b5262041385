from .model import RankingModel, TextNumrEncoder  # noqa: F401
