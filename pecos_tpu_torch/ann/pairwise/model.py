"""PairwiseANN: label-conditioned exact k-NN, in PyTorch.

The port of ``pecos_tpu/ann/pairwise/model.py``.  The model keeps the
training features X and the label matrix Y; a query is a (feature vector,
label) pair, answered by the training rows that carry the label, closest
first.  Y's columns become a padded label -> rows table, so a batch of pairs
is one gather, one batched product and one top-k on the device.  The same
folder format: ``param.json`` + ``feats.npy`` + ``Y.npz``.
"""

from __future__ import annotations

import copy
import dataclasses as dc
import json
import os
from typing import Dict, Tuple

import numpy as np
import scipy.sparse as smat
import torch

import pecos_tpu_torch
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device

_INF = 3.4e38


def _pairwise_predict(Q, feats, rows, vals, *, metric: str, topk: int):
    """Q (B, D), candidate rows (B, cap) -1 padded with their label values ->
    (ids, mask, dists, values), each (B, min(topk, cap)), closest first."""
    F = feats[rows.clamp(0, feats.shape[0] - 1)]  # (B, cap, D)
    dots = torch.bmm(F, Q[:, :, None])[:, :, 0]
    if metric == "ip":
        d = 1.0 - dots
    else:
        d = (Q * Q).sum(1, keepdim=True) + (F * F).sum(-1) - 2.0 * dots
    d = torch.where(rows >= 0, d, _INF)
    k = min(topk, d.shape[1])
    D, idx = torch.sort(d, dim=1, stable=True)  # ties to the lower slot, as lax.top_k
    D, idx = D[:, :k], idx[:, :k]
    I, V = rows.gather(1, idx), vals.gather(1, idx)
    M = (I >= 0) & (D < _INF * 0.5)
    return torch.where(M, I, 0), M, torch.where(M, D, 0.0), torch.where(M, V, 0.0)


class PairwiseANN(pecos_tpu_torch.BaseClass):
    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        metric_type: str = "ip"

    @dc.dataclass
    class PredParams(pecos_tpu_torch.BaseParams):
        batch_size: int = 1024
        only_topk: int = 10
        num_searcher: int = 1  # parity only

    class Searchers(object):
        """Holds the pred params (there are no worker objects to allocate)."""

        def __init__(self, model, pred_params, num_searcher=1):
            self.model = model
            self.pred_params = pred_params

    def __init__(self, feats, Y, metric: str, pred_params=None, device: DeviceLike = "cuda"):
        self.feats = np.asarray(feats, np.float32)
        self.Y = Y.tocsc().astype(np.float32)
        self.metric = metric
        self.pred_params = self.PredParams.from_dict(pred_params)
        self.device = resolve_device(device)
        # padded label -> training rows table
        nnz = np.diff(self.Y.indptr)
        L = self.Y.shape[1]
        cap = max(int(nnz.max()) if L else 0, 1)
        self._rows = np.full((L, cap), -1, np.int32)
        self._vals = np.zeros((L, cap), np.float32)
        r = np.repeat(np.arange(L), nnz)
        o = np.arange(self.Y.nnz) - np.repeat(self.Y.indptr[:-1], nnz)
        self._rows[r, o] = self.Y.indices
        self._vals[r, o] = self.Y.data
        self._dev: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    @property
    def num_input_keys(self):
        return self.feats.shape[0]

    @property
    def num_label_keys(self):
        return self.Y.shape[1]

    @property
    def feat_dim(self):
        return self.feats.shape[1]

    def to(self, device: DeviceLike) -> "PairwiseANN":
        self.device = resolve_device(device)
        return self

    @classmethod
    def train(cls, X, Y, train_params=None, pred_params=None, device: DeviceLike = "cuda", **kwargs) -> "PairwiseANN":
        params = cls.TrainParams.from_dict(train_params)
        params.override_with_kwargs(kwargs)
        feats = np.asarray(X.todense(), np.float32) if smat.issparse(X) else np.asarray(X, np.float32)
        return cls(feats, Y.tocsc(), params.metric_type, pred_params=pred_params, device=device)

    def searchers_create(self, pred_params=None, num_searcher=1):
        pred_params = self.get_pred_params() if pred_params is None else self.PredParams.from_dict(pred_params)
        return self.Searchers(self, pred_params, num_searcher)

    def get_pred_params(self):
        return copy.deepcopy(self.pred_params)

    def _device(self):
        if self.device not in self._dev:
            up = lambda a: torch.from_numpy(a).to(self.device)
            self._dev[self.device] = (up(self.feats), up(self._rows), up(self._vals))
        return self._dev[self.device]

    def predict(self, input_feat, label_keys, searchers=None, is_same_input=False, **kwargs):
        """(Imat, Mmat, Dmat, Vmat), each (batch, only_topk): training row ids
        (uint32), a found mask (uint32), distances and the pair's Y values."""
        pred_params = searchers.pred_params if searchers is not None else self.get_pred_params()
        pred_params.override_with_kwargs(kwargs)
        Q = np.asarray(input_feat.todense(), np.float32) if smat.issparse(input_feat) else np.asarray(input_feat, np.float32)
        if not isinstance(label_keys, np.ndarray):
            raise TypeError("label_keys must be np.ndarray")
        if Q.shape[1] != self.feat_dim:
            raise ValueError(f"input feat dim {Q.shape[1]} != {self.feat_dim}")
        B = label_keys.shape[0]
        if is_same_input:
            Q = np.broadcast_to(Q[0], (B, Q.shape[1]))
        elif Q.shape[0] != B:
            raise ValueError("input_feat rows != label_keys length")
        feats, rows, vals = self._device()
        keys = torch.from_numpy(label_keys.astype(np.int64)).to(self.device)
        topk = pred_params.only_topk
        outs = _pairwise_predict(
            torch.from_numpy(np.ascontiguousarray(Q)).to(self.device), feats, rows[keys].long(), vals[keys],
            metric=self.metric, topk=topk,
        )
        result = []
        for t, dtype in zip(outs, (np.uint32, np.uint32, np.float32, np.float32)):
            a = t.cpu().numpy()
            if a.shape[1] < topk:  # cap < topk
                a = np.hstack([a, np.zeros((B, topk - a.shape[1]), a.dtype)])
            result.append(a.astype(dtype))
        return tuple(result)

    def save(self, model_folder: str):
        os.makedirs(model_folder, exist_ok=True)
        param = self.append_meta(
            {"model": type(self).__name__, "metric": self.metric, "pred_kwargs": self.pred_params.to_dict()}
        )
        with open(os.path.join(model_folder, "param.json"), "w") as f:
            json.dump(param, f, indent=True)
        np.save(os.path.join(model_folder, "feats.npy"), self.feats)
        smat_util.save_matrix(os.path.join(model_folder, "Y.npz"), self.Y)

    @classmethod
    def load(cls, model_folder: str, lazy_load: bool = False, device: DeviceLike = "cuda") -> "PairwiseANN":
        with open(os.path.join(model_folder, "param.json")) as f:
            param = json.load(f)
        feats = np.load(os.path.join(model_folder, "feats.npy"))
        Y = smat_util.load_matrix(os.path.join(model_folder, "Y.npz"))
        keep = ("batch_size", "only_topk", "num_searcher")
        pred = {k: v for k, v in param.get("pred_kwargs", {}).items() if k in keep}
        return cls(feats, Y, param["metric"], pred_params=pred, device=device)
