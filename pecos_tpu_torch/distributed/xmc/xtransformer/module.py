"""Distributed XR-Transformer fine-tuning (counterpart of
``pecos_tpu/distributed/xmc/xtransformer/module.py``).

One process drives a mesh of torch devices (``parallel.mesh``): the batch is
split over the devices, each holding a replica of the encoder, the gradients
are summed on the first, and the AdamW moments are split over all of them
(ZeRO stage 1, ``parallel.mesh.shard_opt_state``).  The reference launches
DeepSpeed processes over NCCL instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from pecos_tpu_torch.parallel.mesh import cuda_devices, make_mesh
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device
from pecos_tpu_torch.xmc.xtransformer.matcher import TransformerMatcher
from pecos_tpu_torch.xmc.xtransformer.module import MLProblemWithText


def dist_fine_tune(
    prob: MLProblemWithText,
    csr_codes=None,
    C=None,
    train_params=None,
    pred_params=None,
    parent_matcher: Optional[TransformerMatcher] = None,
    n_devices: Optional[int] = None,
    device: DeviceLike = "cuda",
):
    """``TransformerMatcher.train`` data-parallel over a mesh of ``n_devices``
    (default: every card).  With ``device="cuda"`` the mesh takes the first
    n cards, or card 0 n times when there are fewer; with ``device="cpu"``
    the CPU n times."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = cuda_devices(n_devices or torch.cuda.device_count())
    else:
        devices = [dev] * (n_devices or 1)
    mesh = make_mesh(len(devices), devices=devices)
    return TransformerMatcher.train(
        prob, csr_codes=csr_codes, C=C, train_params=train_params, pred_params=pred_params,
        parent_matcher=parent_matcher, mesh=mesh,
    )
