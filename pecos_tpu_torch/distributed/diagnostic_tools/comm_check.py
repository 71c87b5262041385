"""Pre-flight checks of the communication layers.

The port of ``pecos_tpu/distributed/diagnostic_tools/comm_check.py``:
``run_comm_self_test`` round-trips host objects through any ``DistComm``;
``run_device_collective_probe`` checks the device data plane, a sum over
every device of a mesh.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from pecos_tpu_torch.parallel.comm import DistComm
from pecos_tpu_torch.parallel.mesh import Mesh, make_mesh

LOGGER = logging.getLogger(__name__)


def run_comm_self_test(comm: DistComm, verbose: bool = True) -> List[str]:
    """Exercise bcast/scatter/gather round trips; returns the names of the failed checks."""
    failures = []
    rank, size = comm.get_rank(), comm.get_size()

    def check(name, ok):
        if verbose:
            LOGGER.info(f"[rank {rank}] {name}: {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)

    got = comm.bcast({"msg": "hello", "arr": np.arange(5)} if rank == 0 else None, root=0)
    check("bcast", got is not None and got["msg"] == "hello" and (got["arr"] == np.arange(5)).all())
    mine = comm.scatter([f"part{r}" for r in range(size)] if rank == 0 else None, root=0)
    check("scatter", mine == f"part{rank}")
    gathered = comm.gather(rank * 10, root=0)
    check("gather", gathered == [r * 10 for r in range(size)] if rank == 0 else gathered is None)
    return failures


def run_device_collective_probe(mesh: Optional[Mesh] = None) -> bool:
    """A block of ones on every device of ``mesh`` (default: every card),
    summed on its first device: the counterpart of a psum over the mesh."""
    mesh = mesh or make_mesh()
    devices = [dev for row in mesh.devices for dev in row]
    total = sum(torch.ones(8, device=dev).sum().to(devices[0]) for dev in devices)
    return float(total) == len(devices) * 8.0
