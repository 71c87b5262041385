"""XLinearModel: user-facing facade over HierarchicalMLModel.

Trains with the modes of ``pecos_tpu.xmc.xlinear.XLinearModel`` (full-model,
matcher, ranker; relevance disable, induce, ranker-only) and reads and writes
the same model folder: ``param.json`` + ``ranker/`` (a HierarchicalMLModel
folder), and the compiled predict-only folder of ``compile_mmap_model``:
``param.json`` + ``compiled/`` (``compiled.json`` + ``layer_{d}.npz``).
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
from pecos_tpu_torch.utils.cluster_util import ClusterChain
from pecos_tpu_torch.utils.torch_util import DeviceLike
from pecos_tpu_torch.xmc import HierarchicalMLModel, MLModel, MLProblem
from pecos_tpu_torch.xmc.base import PredictOnlyHierModel
from pecos_tpu_torch.xmc.inference import load_compiled_layers, save_compiled_layers


def _field_names(params_cls) -> set:
    return {f.name for f in dc.fields(params_cls)}


class XLinearModel(pecos_tpu_torch.BaseClass):
    """Hierarchical linear model for extreme multi-label classification."""

    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        mode: str = "full-model"  # full-model | matcher | ranker
        ranker_level: int = 1
        nr_splits: int = 16
        min_codes: Optional[int] = None
        shallow: bool = False
        rel_mode: str = "disable"  # disable | induce | ranker-only
        rel_norm: str = "no-norm"
        hlm_args: Optional[HierarchicalMLModel.TrainParams] = None

    @dc.dataclass
    class PredParams(pecos_tpu_torch.BaseParams):
        hlm_args: Optional[HierarchicalMLModel.PredParams] = None

        def override_with_kwargs(self, pred_kwargs):
            if self.hlm_args is not None:
                self.hlm_args.override_with_kwargs(pred_kwargs)
            return self

    def __init__(self, model=None):
        self.model = model  # HierarchicalMLModel or PredictOnlyHierModel

    @property
    def nr_labels(self):
        return self.model.nr_labels

    @property
    def device(self):
        return self.model.device

    def _write_param(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "param.json"), "w", encoding="utf-8") as f:
            f.write(json.dumps(self.append_meta({}), indent=True))

    def save(self, model_folder: str):
        self._write_param(model_folder)
        self.model.save(os.path.join(model_folder, "ranker"))

    @classmethod
    def load(
        cls, model_folder: str, is_predict_only: bool = False, device: DeviceLike = "cuda"
    ) -> "XLinearModel":
        """A model folder, or with ``is_predict_only`` a compiled folder when
        one is there (a :class:`PredictOnlyHierModel`), on ``device``."""
        compiled = os.path.join(model_folder, "compiled")
        if is_predict_only and os.path.exists(os.path.join(compiled, "compiled.json")):
            return cls(PredictOnlyHierModel(load_compiled_layers(compiled, device=device)))
        return cls(
            HierarchicalMLModel.load(os.path.join(model_folder, "ranker"), is_predict_only, device=device)
        )

    @classmethod
    def compile_mmap_model(cls, npz_folder: str, mmap_folder: str):
        """Compile a saved model folder into the predict-only layout that
        ``load(..., is_predict_only=True)`` reads.  The layouts are built on
        the CPU: compiling needs no GPU."""
        hlm = cls.load(npz_folder, device="cpu").model
        compiled = hlm._get_compiled()
        save_compiled_layers(compiled.layers, compiled.bias, compiled.nr_features, os.path.join(mmap_folder, "compiled"))
        cls()._write_param(mmap_folder)

    @classmethod
    def train(
        cls,
        X,
        Y,
        C=None,
        R=None,
        user_supplied_negatives=None,
        train_params: Optional["XLinearModel.TrainParams"] = None,
        pred_params: Optional["XLinearModel.PredParams"] = None,
        device: DeviceLike = "cuda",
        **kwargs,
    ) -> "XLinearModel":
        """Train on ``device`` over the cluster chain C (None: one flat layer).

        Modes: ``full-model`` trains the whole chain; ``matcher`` the top
        layers on Y rolled up past the bottom ``ranker_level`` layers;
        ``ranker`` the bottom ``ranker_level`` layers alone.  Relevance R:
        ``disable`` ignores it with a chain, ``induce`` rolls R (or Y) up to
        every layer, ``ranker-only`` gives it to the bottom layer.
        ``user_supplied_negatives`` is a partial chain dict keyed by levels
        above the leaf (``ClusterChain.generate_matching_chain``).

        Without train_params, kwargs give the fields of XLinearModel and
        MLModel TrainParams and ``negative_sampling_scheme``; ``pred_kwargs``
        (default: beam_size / only_topk / post_processor from kwargs)
        overrides every layer's pred params.
        """
        if train_params is None:
            train_params = cls.TrainParams.from_dict({k: v for k, v in kwargs.items() if k in _field_names(cls.TrainParams)})
            train_params.hlm_args = HierarchicalMLModel.TrainParams(
                neg_mining_chain=kwargs.get("negative_sampling_scheme", "tfn"),
                model_chain=MLModel.TrainParams.from_dict(
                    {k: v for k, v in kwargs.items() if k in _field_names(MLModel.TrainParams)}
                ),
            )
        else:
            train_params = cls.TrainParams.from_dict(train_params)
        if pred_params is None:
            pred_params = cls.PredParams(hlm_args=HierarchicalMLModel.PredParams(model_chain=MLModel.PredParams()))
        else:
            pred_params = cls.PredParams.from_dict(pred_params)
        if kwargs.get("pred_kwargs") is None:
            kwargs["pred_kwargs"] = {k: kwargs.get(k) for k in ("beam_size", "only_topk", "post_processor")}
        if train_params.rel_mode not in ("disable", "induce", "ranker-only"):
            raise ValueError(f"rel_mode must be one of disable/induce/ranker-only, got {train_params.rel_mode!r}")
        if train_params.mode not in ("full-model", "matcher", "ranker"):
            raise ValueError(f"mode must be one of full-model/matcher/ranker, got {train_params.mode!r}")

        clustering = matching_chain = relevance_chain = None
        if C is not None and not (isinstance(C, (list, tuple)) and len(C) == 0):
            if train_params.shallow:
                clustering = ClusterChain.from_partial_chain(C, min_codes=None)
            else:
                clustering = ClusterChain.from_partial_chain(
                    C, min_codes=train_params.min_codes or train_params.nr_splits, nr_splits=train_params.nr_splits
                )
            matching_chain = clustering.generate_matching_chain(user_supplied_negatives)
            if train_params.rel_mode == "disable":
                relevance_chain = [None] * len(clustering)
            else:
                induce = train_params.rel_mode == "induce"
                R0 = R if R is not None or not induce else smat_util.binarized(Y)
                relevance_chain = clustering.generate_relevance_chain({0: R0}, norm_type=train_params.rel_norm, induce=induce)

        if train_params.mode != "full-model":
            if clustering is None:
                raise ValueError(f"{train_params.mode} mode needs a clustering with >= 2 levels (got none)")
            split = len(clustering) - train_params.ranker_level  # the matcher's layers come before it
            if train_params.mode == "matcher":
                for C_r in clustering[split:][::-1]:
                    Y = (Y @ C_r).tocsc()
                keep = slice(None, split)
            else:
                keep = slice(split, None)
            clustering = ClusterChain(clustering[keep])
            matching_chain, relevance_chain = matching_chain[keep], relevance_chain[keep]

        model = HierarchicalMLModel.train(
            MLProblem(X, Y, R=R if C is None else None),
            clustering=clustering,
            relevance_chain=relevance_chain,
            matching_chain=matching_chain,
            train_params=train_params.hlm_args,
            pred_params=pred_params.hlm_args,
            device=device,
            **kwargs,
        )
        return cls(model)

    @staticmethod
    def load_feature_matrix(path: str, dtype=np.float32):
        return smat_util.load_feature_matrix(path, dtype=dtype)

    @staticmethod
    def load_label_matrix(path: str, dtype=np.float32):
        return smat_util.load_label_matrix(path, dtype=dtype)

    def predict(self, X, pred_params=None, **kwargs) -> smat.csr_matrix:
        """Beam-search predict; kwargs: beam_size, only_topk, post_processor,
        wire_value_dtype, csr_codes, and mesh (a ``parallel.mesh.Mesh``: the
        label-sharded predict over its devices)."""
        return self.model.predict(
            X,
            csr_codes=kwargs.pop("csr_codes", None),
            pred_params=pred_params.hlm_args if pred_params is not None else None,
            **kwargs,
        )

    def predict_on_selected_outputs(self, X, selected_outputs_csr, **kwargs):
        return self.model.predict_on_selected_outputs(X, selected_outputs_csr, **kwargs)

    def realtime_session(self, **kwargs):
        """Open a persistent low-latency predict session (inference.RealtimeSession)."""
        return self.model.realtime_session(**kwargs)

    def set_output_constraint(self, labels_to_keep):
        """Prune the tree so that predict returns only the given labels."""
        self.model.set_output_constraint(labels_to_keep)

    def get_submodel_rooted_at(self, given_depth, child_node_id, reindex=False):
        return self.model.get_submodel_rooted_at(given_depth, child_node_id, reindex)

    def split_model_at_depth(self, given_depth, reindex=False):
        return self.model.split_model_at_depth(given_depth, reindex)

    def get_pred_params(self) -> "XLinearModel.PredParams":
        return self.PredParams(hlm_args=self.model.get_pred_params())

    @classmethod
    def reconstruct_model(cls, meta_model, sub_models) -> "XLinearModel":
        """One chain from a meta (upper-tree) model and per-subtree child
        models of equal depth: each layer below the meta model stacks the sub
        models' W side by side and their C block-diagonally, in subtree order."""
        meta = meta_model.model if isinstance(meta_model, XLinearModel) else meta_model
        subs = [m.model if isinstance(m, XLinearModel) else m for m in sub_models]
        if any(s.depth != subs[0].depth for s in subs):
            raise ValueError("all sub models must share depth")
        chain = list(meta.model_chain)
        for layers in zip(*(s.model_chain for s in subs)):
            chain.append(
                MLModel(
                    W=smat_util.hstack_csc([m.W for m in layers]),
                    C=smat_util.block_diag_csc([m.C for m in layers]),
                    bias=layers[0].bias,
                    pred_params=layers[0].get_pred_params(),
                    device=meta.device,
                )
            )
        return cls(HierarchicalMLModel(chain))
