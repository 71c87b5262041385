from .model import HNSW, HNSWProductQuantizer4Bits  # noqa: F401
