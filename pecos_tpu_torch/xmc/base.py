"""XMC model classes for predict: MLModel (one layer) and HierarchicalMLModel.

The predict side of ``pecos_tpu/xmc/base.py``.  Model folders have the same
layout as the JAX package writes: ``param.json`` + ``W.npz``/``C.npz`` per
layer, ``{d}.model`` subfolders for the chain, so a model saved by either
package loads in the other.  Training is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import copy
import dataclasses as dc
import json
import os
from typing import Any, List, Optional

import numpy as np
import scipy.sparse as smat

import pecos_tpu_torch
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device
from .inference import CompiledHierModel, DeviceLayer, build_device_layer
from .postprocessor import PostProcessor


class MLModel(pecos_tpu_torch.BaseClass):
    """One tree layer: weight matrix W (D+bias, L) CSC + cluster matrix C (L, K),
    predicted on ``device``."""

    @dc.dataclass
    class PredParams(pecos_tpu_torch.BaseParams):
        only_topk: int = 20
        post_processor: str = "l3-hinge"

        def is_valid(self):
            return self.post_processor in PostProcessor.valid_list()

    def __init__(self, W=None, C=None, bias: float = -1.0, pred_params=None, device: DeviceLike = "cuda"):
        if W is None:
            raise ValueError("W is required")
        self.W = W.tocsc().astype(np.float32) if smat.issparse(W) else smat.csc_matrix(W, dtype=np.float32)
        if C is None:
            C = smat.csc_matrix(np.ones((self.W.shape[1], 1), dtype=np.float32))
        self.C = C.tocsc().astype(np.float32) if smat.issparse(C) else smat.csc_matrix(C, dtype=np.float32)
        self.bias = float(bias)
        self.pred_params = self.PredParams.from_dict(pred_params)
        self.device = resolve_device(device)
        self._device_layer: Optional[DeviceLayer] = None

    @property
    def nr_labels(self):
        return self.W.shape[1]

    @property
    def nr_features(self):
        return self.W.shape[0] - (1 if self.bias > 0 else 0)

    @property
    def nr_codes(self):
        return self.C.shape[1]

    def get_pred_params(self):
        return copy.deepcopy(self.pred_params)

    @property
    def device_layer(self) -> DeviceLayer:
        if self._device_layer is None:
            self._device_layer = build_device_layer(self.W, self.C, device=self.device)
        return self._device_layer

    def save(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        param = self.append_meta(
            {
                "model": type(self).__name__,
                "nr_labels": self.nr_labels,
                "nr_features": self.nr_features,
                "nr_codes": self.nr_codes,
                "bias": self.bias,
                "pred_kwargs": self.pred_params.to_dict(),
            }
        )
        with open(os.path.join(folder, "param.json"), "w") as f:
            json.dump(param, f, indent=True)
        smat_util.save_matrix(os.path.join(folder, "W.npz"), self.W)
        smat_util.save_matrix(os.path.join(folder, "C.npz"), self.C)

    @classmethod
    def load(cls, folder: str, device: DeviceLike = "cuda") -> "MLModel":
        with open(os.path.join(folder, "param.json")) as f:
            param = json.load(f)
        pred_params = param.get("pred_kwargs", None)
        if pred_params is not None:
            # the params' __meta__ names the writing package's class: keep the fields only
            pred_params = {k: v for k, v in pred_params.items() if k in ("only_topk", "post_processor")}
        return cls(
            W=smat_util.load_matrix(os.path.join(folder, "W.npz")),
            C=smat_util.load_matrix(os.path.join(folder, "C.npz")),
            bias=param.get("bias", -1.0),
            pred_params=pred_params,
            device=device,
        )


class HierarchicalMLModel(pecos_tpu_torch.BaseClass):
    """Chain of MLModels forming the hierarchical linear model; predicts on
    the device its layers share."""

    @dc.dataclass
    class PredParams(pecos_tpu_torch.BaseParams):
        model_chain: Any = None  # tuple of MLModel.PredParams, one per layer

        def override_with_kwargs(self, pred_kwargs):
            if pred_kwargs is not None and self.model_chain is not None:
                for p in self.model_chain:
                    p.override_with_kwargs(pred_kwargs)
            return self

    def __init__(self, model_chain, pred_params=None, is_predict_only: bool = False):
        if isinstance(model_chain, MLModel):
            model_chain = [model_chain]
        self.model_chain: List[MLModel] = list(model_chain)
        devices = {m.device for m in self.model_chain}
        if len(devices) != 1:
            raise ValueError(f"all layers must be on one device, got {sorted(map(str, devices))}")
        if pred_params is None:
            pred_params = self.PredParams(model_chain=tuple(m.get_pred_params() for m in self.model_chain))
        self.pred_params = pred_params
        self.is_predict_only = is_predict_only
        self._compiled: Optional[CompiledHierModel] = None

    @property
    def depth(self):
        return len(self.model_chain)

    @property
    def nr_labels(self):
        return self.model_chain[-1].nr_labels

    @property
    def nr_features(self):
        return self.model_chain[0].nr_features

    @property
    def nr_codes(self):
        return self.model_chain[0].nr_codes

    @property
    def device(self):
        return self.model_chain[0].device

    def get_pred_params(self):
        return copy.deepcopy(self.pred_params)

    def save(self, folder: str):
        if self.is_predict_only:
            raise Exception("Model is predict only! save not supported!")
        os.makedirs(folder, exist_ok=True)
        param = self.append_meta(
            {
                "model": type(self).__name__,
                "depth": self.depth,
                "nr_features": self.nr_features,
                "nr_codes": self.nr_codes,
                "nr_labels": self.nr_labels,
            }
        )
        with open(os.path.join(folder, "param.json"), "w", encoding="utf-8") as f:
            json.dump(param, f, indent=True)
        for d, model in enumerate(self.model_chain):
            model.save(os.path.join(folder, f"{d}.model"))

    @classmethod
    def load(
        cls, folder: str, is_predict_only: bool = False, device: DeviceLike = "cuda"
    ) -> "HierarchicalMLModel":
        with open(os.path.join(folder, "param.json")) as f:
            param = json.load(f)
        chain = [
            MLModel.load(os.path.join(folder, f"{d}.model"), device=device) for d in range(param["depth"])
        ]
        return cls(chain, is_predict_only=is_predict_only)

    def _get_compiled(self) -> CompiledHierModel:
        if self._compiled is None:
            self._compiled = CompiledHierModel(
                [m.device_layer for m in self.model_chain],
                bias=self.model_chain[0].bias,
                nr_features=self.nr_features,
            )
        return self._compiled

    def predict(
        self,
        X,
        csr_codes: Optional[smat.csr_matrix] = None,
        pred_params: Optional["HierarchicalMLModel.PredParams"] = None,
        **kwargs,
    ) -> smat.csr_matrix:
        """Whole-chain beam search on the model's device.

        kwargs: beam_size (default 10), only_topk, post_processor override.
        """
        if csr_codes is not None:
            raise NotImplementedError(
                "predict with csr_codes (the per-layer loop over single_layer_predict) is not "
                "ported yet; see ROADMAP.md, 'single_layer_predict / csr_codes loop'"
            )
        if kwargs.pop("mesh", None) is not None:
            raise NotImplementedError(
                "the mesh kwarg (label-sharded predict) is not ported yet; see ROADMAP.md, "
                "'multi-device'"
            )
        beam_size = kwargs.get("beam_size", 10) or 10
        pred_params = self.get_pred_params() if pred_params is None else pred_params
        pred_params.override_with_kwargs(kwargs)
        return self._get_compiled().predict(
            X,
            beam_size=beam_size,
            only_topk=pred_params.model_chain[-1].only_topk,
            post_processor=tuple(p.post_processor for p in pred_params.model_chain),
        )
