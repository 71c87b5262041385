"""A mesh of torch devices for sharded XR-Linear, and the host-level comm layer.

The port of ``pecos_tpu/parallel``: ``mesh`` holds a (dp, lp) grid of torch
devices driven by one process and the sharded solve and predict steps over
it; ``comm`` carries host objects between the ranks of distributed training.
"""

from .comm import DistComm, DummyComm  # noqa: F401
from .mesh import Mesh, make_mesh, shard_solve_block  # noqa: F401
