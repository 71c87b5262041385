from .model import DistributedXLinearModel, XLinearLoadBalancer  # noqa: F401
