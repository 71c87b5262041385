"""XMC model classes for predict: MLModel (one layer), PredictOnlyHierModel
and HierarchicalMLModel.

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
from .inference import (
    CompiledHierModel,
    DeviceLayer,
    build_device_layer,
    score_selected_labels,
    single_layer_predict,
)
from .postprocessor import PostProcessor


def _quartiles(v: np.ndarray) -> dict:
    if len(v) == 0:
        return dict(min=0, q1=0, median=0, q3=0, max=0, mean=0.0)
    q = np.percentile(v, [0, 25, 50, 75, 100])
    return dict(min=int(q[0]), q1=int(q[1]), median=int(q[2]), q3=int(q[3]), max=int(q[4]), mean=float(np.mean(v)))


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

    def astype(self, dtype):
        return MLModel(self.W.astype(dtype), self.C.astype(dtype), self.bias, self.pred_params, device=self.device)

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

    def _resolve_pred_params(self, pred_params, kwargs) -> "MLModel.PredParams":
        p = self.get_pred_params() if pred_params is None else copy.deepcopy(pred_params)
        p.override_with_kwargs(kwargs)
        if not p.is_valid():
            raise ValueError(f"pred_params is not valid: unknown post_processor {p.post_processor!r}")
        return p

    def predict(
        self,
        X,
        csr_codes: Optional[smat.spmatrix] = None,
        pred_params: Optional["MLModel.PredParams"] = None,
        **kwargs,
    ) -> smat.csr_matrix:
        """Top-k of this layer's labels on the model's device.  ``csr_codes``
        (N, nr_codes), a previous layer's predictions, restricts candidates to
        the children of its active codes and combines with its values."""
        if X.shape[1] != self.nr_features:
            raise ValueError("Feature dimension of query matrix does not match weight matrix")
        p = self._resolve_pred_params(pred_params, kwargs)
        return single_layer_predict(self.device_layer, X, self.bias, csr_codes, p.only_topk, p.post_processor)

    def predict_numpy(
        self,
        X,
        csr_codes: Optional[smat.spmatrix] = None,
        only_topk: Optional[int] = None,
        post_processor: Optional[str] = None,
    ) -> smat.csr_matrix:
        """Independent numpy version of :meth:`predict` (dense; small sizes
        only), the anchor the device path is held against."""
        only_topk = self.pred_params.only_topk if only_topk is None else only_topk
        pp = PostProcessor.get(self.pred_params.post_processor if post_processor is None else post_processor)
        Xd = np.asarray(X.todense() if smat.issparse(X) else X, np.float32)
        if self.bias > 0:
            Xd = np.hstack([Xd, np.full((Xd.shape[0], 1), self.bias, np.float32)])
        scores = pp.transform_np(Xd @ self.W.toarray())  # (N, L)
        if csr_codes is not None:
            parent = self.C.tocsr().indices  # each label's code
            codes = csr_codes.toarray()
            scores = np.where(codes[:, parent] != 0, pp.combiner_np(scores, codes[:, parent]), -np.inf)
        scores = np.where(np.isfinite(scores), scores, -np.inf)
        k = min(only_topk, scores.shape[1])
        idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        top = np.take_along_axis(scores, idx, axis=1)
        keep = top > -np.inf
        return smat_util.csr_from_topk_arrays(np.where(keep, idx, -1), np.where(keep, top, 0.0), self.nr_labels)

    def predict_on_selected_outputs(
        self,
        X,
        selected_outputs_csr: smat.spmatrix,
        csr_codes: Optional[smat.spmatrix] = None,
        pred_params: Optional["MLModel.PredParams"] = None,
        **kwargs,
    ) -> smat.csr_matrix:
        """Scores of the given (instance, label) pairs only, combined with the
        parent codes' values in ``csr_codes`` when it is given (a pair whose
        code is absent from it combines with 0)."""
        p = self._resolve_pred_params(pred_params, kwargs)
        pp = PostProcessor.get(p.post_processor)
        sel = selected_outputs_csr.tocsr()
        if sel.shape[1] != self.nr_labels:
            raise ValueError("Label dimension of selected output matrix does not match")
        N = sel.shape[0]
        counts = np.diff(sel.indptr)
        cap = max(8, 1 << max(int(counts.max()) - 1, 0).bit_length()) if N else 8
        labels = np.full((N, cap), -1, np.int64)
        rows = np.repeat(np.arange(N), counts)
        labels[rows, np.arange(sel.nnz) - np.repeat(sel.indptr[:-1], counts)] = sel.indices
        val = pp.transform_np(score_selected_labels(self.device_layer, X, self.bias, labels))
        if csr_codes is not None:
            code = self.C.tocsr().indices[np.clip(labels, 0, self.nr_labels - 1)]
            prior = np.asarray(csr_codes.tocsr()[np.repeat(np.arange(N), cap), code.ravel()]).reshape(N, cap)
            val = pp.combiner_np(val, prior)
        return smat_util.csr_from_topk_arrays(labels, np.where(labels >= 0, val, 0.0), self.nr_labels)

    def get_submodel(self, selected_codes=None, selected_labels=None, reindex=False):
        """The part of this layer that connects ``selected_codes`` and
        ``selected_labels`` (all by default): ``{'model', 'active_labels',
        'active_codes'}``.  With ``reindex`` the model keeps only the active
        labels and codes, renumbered in order; without it W and C keep their
        shapes with everything else zeroed."""
        for name, sel, n in (("selected_codes", selected_codes, self.nr_codes), ("selected_labels", selected_labels, self.nr_labels)):
            if sel is not None and len(sel) and max(sel) >= n:
                raise ValueError(f"{name} out of range")
        codes = np.arange(self.nr_codes) if selected_codes is None else selected_codes
        labels = np.arange(self.nr_labels) if selected_labels is None else selected_labels
        coo = smat_util.get_sparsified_coo(smat.coo_matrix(self.C), labels, codes)
        active_labels = np.unique(coo.row)
        active_codes = np.unique(coo.col)
        if reindex:
            new_C = smat.csc_matrix(
                (coo.data, (np.searchsorted(active_labels, coo.row), np.searchsorted(active_codes, coo.col))),
                shape=(len(active_labels), len(active_codes)),
            )
            new_W = self.W[:, active_labels]
        else:
            new_C = coo.tocsc()
            new_W = smat_util.get_sparsified_coo(smat.coo_matrix(self.W), np.arange(self.W.shape[0]), active_labels).tocsc()
        model = MLModel(C=new_C, W=new_W, bias=self.bias, pred_params=self.get_pred_params(), device=self.device)
        return {"model": model, "active_labels": active_labels, "active_codes": active_codes}


def _chain_pred_params(pred_params, default, kwargs):
    """(only_topk of the last layer, per-layer post-processor names) from
    ``pred_params`` (default ``default``) overridden by ``kwargs``."""
    p = copy.deepcopy(default if pred_params is None else pred_params)
    p.override_with_kwargs(kwargs)
    return p.model_chain[-1].only_topk, tuple(q.post_processor for q in p.model_chain)


def _reject_mesh(kwargs):
    if kwargs.pop("mesh", None) is not None:
        raise NotImplementedError(
            "the mesh kwarg (label-sharded predict) is not ported yet; see ROADMAP.md, 'multi-device'"
        )


class PredictOnlyHierModel(pecos_tpu_torch.BaseClass):
    """Predict-only model over a compiled device layout (a folder written by
    ``compile_mmap_model``): it predicts and opens realtime sessions; save,
    ``csr_codes`` and model surgery are not supported."""

    def __init__(self, compiled: CompiledHierModel):
        self._compiled = compiled
        self.is_predict_only = True

    @property
    def depth(self):
        return self._compiled.depth

    @property
    def nr_labels(self):
        return self._compiled.nr_labels

    @property
    def nr_features(self):
        return self._compiled.nr_features

    @property
    def device(self):
        return self._compiled.device

    def get_pred_params(self):
        return HierarchicalMLModel.PredParams(model_chain=tuple(MLModel.PredParams() for _ in range(self.depth)))

    def predict(self, X, csr_codes=None, pred_params=None, **kwargs):
        """Whole-chain beam search; kwargs: beam_size (default 10), only_topk,
        post_processor, wire_value_dtype."""
        if csr_codes is not None:
            raise ValueError("model is predict only: csr_codes is not supported")
        _reject_mesh(kwargs)
        beam_size = kwargs.pop("beam_size", None) or 10
        wire = kwargs.pop("wire_value_dtype", "float32")
        only_topk, pp_names = _chain_pred_params(pred_params, self.get_pred_params(), kwargs)
        return self._compiled.predict(
            X, beam_size=beam_size, only_topk=only_topk, post_processor=pp_names, wire_value_dtype=wire
        )

    def save(self, folder):
        raise ValueError("model is predict only: save is not supported")

    def _get_compiled(self):
        return self._compiled

    def realtime_session(self, **kwargs):
        """Persistent low-latency predict session (inference.RealtimeSession)."""
        return self._compiled.realtime_session(**kwargs)


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

    def __add__(self, other: "HierarchicalMLModel") -> "HierarchicalMLModel":
        """The chain of ``self`` followed by ``other`` (whose top codes must be
        ``self``'s labels)."""
        if not isinstance(other, HierarchicalMLModel):
            raise ValueError("can only add HierarchicalMLModel")
        if self.nr_labels != other.nr_codes:
            raise ValueError("chains are not compatible")
        chain = tuple(self.pred_params.model_chain) + tuple(other.pred_params.model_chain)
        return HierarchicalMLModel(self.model_chain + other.model_chain, pred_params=self.PredParams(model_chain=chain))

    def __getitem__(self, key) -> "HierarchicalMLModel":
        """A sub-chain: an int gives one layer, a slice the layers in it."""
        key = slice(key, key + 1) if isinstance(key, int) else key
        return HierarchicalMLModel(
            self.model_chain[key], pred_params=self.PredParams(model_chain=tuple(self.pred_params.model_chain[key]))
        )

    def astype(self, dtype):
        return HierarchicalMLModel([m.astype(dtype) for m in self.model_chain], self.pred_params, self.is_predict_only)

    def get_pred_params(self):
        return copy.deepcopy(self.pred_params)

    def save(self, folder: str):
        if self.is_predict_only:
            raise ValueError("model is predict only: save is not supported")
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

    def realtime_session(self, **kwargs):
        """Persistent low-latency predict session (inference.RealtimeSession)."""
        return self._get_compiled().realtime_session(**kwargs)

    def predict(
        self,
        X,
        csr_codes: Optional[smat.spmatrix] = None,
        pred_params: Optional["HierarchicalMLModel.PredParams"] = None,
        **kwargs,
    ) -> smat.csr_matrix:
        """Whole-chain beam search on the model's device.

        kwargs: beam_size (default 10), only_topk, post_processor override,
        wire_value_dtype.  With ``csr_codes`` (a starting beam over the top
        layer's codes) the chain runs layer by layer through MLModel.predict.
        """
        _reject_mesh(kwargs)
        beam_size = kwargs.pop("beam_size", None) or 10
        if csr_codes is not None:
            p = self.get_pred_params() if pred_params is None else copy.deepcopy(pred_params)
            p.override_with_kwargs(kwargs)
            return self._predict_layer_loop(X, csr_codes=csr_codes, pred_params=p, beam_size=beam_size)
        wire = kwargs.pop("wire_value_dtype", "float32")
        only_topk, pp_names = _chain_pred_params(pred_params, self.pred_params, kwargs)
        return self._get_compiled().predict(
            X, beam_size=beam_size, only_topk=only_topk, post_processor=pp_names, wire_value_dtype=wire
        )

    def _predict_layer_loop(
        self,
        X,
        csr_codes: Optional[smat.spmatrix] = None,
        pred_params: Optional["HierarchicalMLModel.PredParams"] = None,
        beam_size: int = 10,
    ) -> smat.csr_matrix:
        """Layer-by-layer predict through MLModel.predict, each layer's top
        ``beam_size`` (the last layer's only_topk) feeding the next as codes."""
        pred_params = self.get_pred_params() if pred_params is None else pred_params
        pred = csr_codes
        for d, model in enumerate(self.model_chain):
            p = copy.deepcopy(pred_params.model_chain[d])
            if d != self.depth - 1:
                p.only_topk = beam_size
            pred = model.predict(X, csr_codes=pred, pred_params=p)
        return pred

    def predict_on_selected_outputs(
        self,
        X,
        selected_outputs_csr: smat.spmatrix,
        pred_params: Optional["HierarchicalMLModel.PredParams"] = None,
        **kwargs,
    ) -> smat.csr_matrix:
        """Path scores of the selected (instance, label) pairs through the whole
        chain: the selection is rolled up to every level, and each level scores
        its selected pairs combined with the level above."""
        pred_params = self.get_pred_params() if pred_params is None else copy.deepcopy(pred_params)
        pred_params.override_with_kwargs(kwargs)
        selected = [smat_util.binarized(selected_outputs_csr)]
        for model in self.model_chain[:0:-1]:
            selected.insert(0, smat_util.binarized(selected[0] @ model.C))
        pred = None
        for model, sel, p in zip(self.model_chain, selected, pred_params.model_chain):
            pred = model.predict_on_selected_outputs(X, sel, csr_codes=pred, pred_params=p)
        return pred

    def _check_mutable(self, what: str):
        if self.is_predict_only:
            raise ValueError(f"model is predict only: {what} is not supported")

    def set_output_constraint(self, labels_to_keep):
        """Prune the tree bottom-up so that predict reaches only ``labels_to_keep``."""
        self._check_mutable("set_output_constraint")
        keep = np.zeros(self.nr_labels, bool)
        keep[np.fromiter(labels_to_keep, dtype=np.int64)] = True
        for model in self.model_chain[::-1]:
            if keep.all():
                break
            C = model.C.tocsc(copy=True)
            C.data[~keep[C.indices]] = 0
            C.eliminate_zeros()
            model.C = C
            model._device_layer = None
            keep = np.diff(C.indptr) > 0  # a code lives on while one of its children does
        self._compiled = None

    def get_submodel_rooted_at(self, given_depth: int, child_node_id: int, reindex: bool = False):
        """The subtree under code ``child_node_id`` of layer ``given_depth`` as
        a HierarchicalMLModel, and with ``reindex`` its labels' ids in this
        model (None without)."""
        self._check_mutable("get_submodel_rooted_at")
        chain, parents = [], [child_node_id]
        for d in range(given_depth, self.depth):
            sub = self.model_chain[d].get_submodel(selected_codes=parents, reindex=reindex)
            model = sub["model"]
            if d == given_depth and not reindex:
                # the root layer keeps one code column: the subtree's root
                model = MLModel(C=model.C[:, parents], W=model.W, bias=model.bias,
                                pred_params=model.get_pred_params(), device=model.device)
            chain.append(model)
            parents = sub["active_labels"]
        return HierarchicalMLModel(chain), (parents if reindex else None)

    def split_model_at_depth(self, given_depth: int, reindex: bool = False):
        """``{'parent_model': layers above given_depth, 'child_models': one
        get_submodel_rooted_at result per code of layer given_depth}``."""
        self._check_mutable("split_model_at_depth")
        if not 1 <= given_depth <= self.depth - 1:
            raise ValueError("given_depth must be in [1, depth-1]")
        return {
            "parent_model": self[:given_depth],
            "child_models": [
                self.get_submodel_rooted_at(given_depth, i, reindex)
                for i in range(self.model_chain[given_depth].nr_codes)
            ],
        }

    def get_layer_statistics(self):
        """Per layer: nr_labels, nr_codes and quartiles of the nonzeros per
        column of W and of C."""
        return [
            {
                "nr_labels": m.nr_labels,
                "nr_codes": m.nr_codes,
                "w_col_nnz": _quartiles(np.diff(m.W.tocsc().indptr)),
                "c_col_nnz": _quartiles(np.diff(m.C.tocsc().indptr)),
            }
            for m in self.model_chain
        ]
