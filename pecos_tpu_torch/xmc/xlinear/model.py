"""XLinearModel: user-facing facade over HierarchicalMLModel (predict side).

Reads and writes the same model folder as ``pecos_tpu.xmc.xlinear.XLinearModel``:
``param.json`` + ``ranker/`` (a HierarchicalMLModel folder).  Training is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses as dc
import json
import os
from typing import Optional

import numpy as np
import scipy.sparse as smat

import pecos_tpu_torch
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.torch_util import DeviceLike
from pecos_tpu_torch.xmc import HierarchicalMLModel


class XLinearModel(pecos_tpu_torch.BaseClass):
    """Hierarchical linear model for extreme multi-label classification."""

    @dc.dataclass
    class PredParams(pecos_tpu_torch.BaseParams):
        hlm_args: Optional[HierarchicalMLModel.PredParams] = None

        def override_with_kwargs(self, pred_kwargs):
            if self.hlm_args is not None:
                self.hlm_args.override_with_kwargs(pred_kwargs)
            return self

    def __init__(self, model: Optional[HierarchicalMLModel] = None):
        self.model = model

    @property
    def nr_labels(self):
        return self.model.nr_labels

    @property
    def device(self):
        return self.model.device

    def save(self, model_folder: str):
        os.makedirs(model_folder, exist_ok=True)
        with open(os.path.join(model_folder, "param.json"), "w", encoding="utf-8") as f:
            f.write(json.dumps(self.append_meta({}), indent=True))
        self.model.save(os.path.join(model_folder, "ranker"))

    @classmethod
    def load(
        cls, model_folder: str, is_predict_only: bool = False, device: DeviceLike = "cuda"
    ) -> "XLinearModel":
        if is_predict_only and os.path.exists(os.path.join(model_folder, "compiled", "compiled.json")):
            raise NotImplementedError(
                "loading the compiled predict-only layout (load_compiled_layers / "
                "PredictOnlyHierModel / MmapCompiledHierModel) is not ported yet; see ROADMAP.md"
            )
        return cls(
            HierarchicalMLModel.load(os.path.join(model_folder, "ranker"), is_predict_only, device=device)
        )

    @staticmethod
    def load_feature_matrix(path: str, dtype=np.float32):
        return smat_util.load_feature_matrix(path, dtype=dtype)

    @staticmethod
    def load_label_matrix(path: str, dtype=np.float32):
        return smat_util.load_label_matrix(path, dtype=dtype)

    def predict(self, X, pred_params=None, **kwargs) -> smat.csr_matrix:
        """Beam-search predict; kwargs: beam_size, only_topk, post_processor."""
        return self.model.predict(
            X,
            csr_codes=kwargs.pop("csr_codes", None),
            pred_params=pred_params.hlm_args if pred_params is not None else None,
            **kwargs,
        )

    def get_pred_params(self) -> "XLinearModel.PredParams":
        return self.PredParams(hlm_args=self.model.get_pred_params())
