"""XMC model classes: MLProblem, MLModel (one layer), PredictOnlyHierModel
and HierarchicalMLModel, trained and predicted on a torch device.

The port of ``pecos_tpu/xmc/base.py``.  Training solves every layer's
per-label problems with the batched Newton-CG of ``xmc/solvers.py``: one
masked dense solve per label block when the layer is dense-ish, otherwise
one solve per bucket of same-shape clusters, each cluster gathered to its
active rows and feature union.  The host keeps the bookkeeping (numpy/scipy);
the device holds X and runs the solves.  Model folders have the layout the
JAX package writes: ``param.json`` + ``W.npz``/``C.npz`` per layer,
``{d}.model`` subfolders for the chain, so a model saved by either package
loads in the other.
"""

from __future__ import annotations

import copy
import dataclasses as dc
import json
import logging
import os
from collections import deque
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import scipy.sparse as smat
import torch

import pecos_tpu_torch
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.cluster_util import ClusterChain
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device
from . import solvers
from .inference import (
    CompiledHierModel,
    DeviceLayer,
    _upload,
    build_device_layer,
    prepare_queries_padded,
    scatter_queries,
    score_selected_labels,
    single_layer_predict,
)
from .postprocessor import PostProcessor

LOGGER = logging.getLogger(__name__)

# cap on elements per (N x Lb) solver block intermediate
_SOLVER_BLOCK_BUDGET = 1 << 26
# padded P*F elements above which a cluster leaves the local-dense bucket
# solver for the global sparse-rows solver (tests shrink it to reach that
# path on toy data)
_LOCAL_DENSE_BUDGET = 1 << 27
# elements of one bucket chunk's local dense X (Cb * P2 * F2)
_BUCKET_CHUNK_ELEMENTS = 1 << 24


def _pow2(v, lo: int = 8):
    """The next power of two >= v, at least ``lo`` (elementwise for arrays)."""
    if np.ndim(v):
        return np.maximum(lo, 2 ** np.ceil(np.log2(np.maximum(v, 1))).astype(np.int64))
    return max(lo, 1 << max(int(v) - 1, 0).bit_length())


def _scatter_dense(ids: torch.Tensor, vals: torch.Tensor, D: int, bias: float) -> torch.Tensor:
    """Padded sparse rows (N, cap), pad id D+1, as a contiguous dense (N, Db)
    float32 on their device: [X | bias] with bias > 0, X alone otherwise."""
    X = scatter_queries(ids, vals, D, bias)
    return (X if bias > 0 else X[:, :D]).contiguous()


def _dense_X_device(X, bias: float, device: torch.device) -> torch.Tensor:
    """Dense [X | bias] (N, Db) on ``device``, built from one nnz-sized padded
    upload and a scatter on the device, and cached on the matrix object.  The
    cache is keyed by bias, device and the identity of the CSR buffers, so
    replacing them invalidates it (writing into X.data in place does not)."""
    if not smat.issparse(X):
        Xd = np.asarray(X, np.float32)
        if bias > 0:
            Xd = np.hstack([Xd, np.full((Xd.shape[0], 1), bias, np.float32)])
        return _upload(np.ascontiguousarray(Xd), device)
    A = X.tocsr()
    key = (float(bias), device)
    cached = getattr(A, "_ptpu_xdev", None)
    if cached is not None and cached[0] == key and all(a is b for a, b in zip(cached[1:4], (A.indptr, A.indices, A.data))):
        return cached[4]
    ids, vals = prepare_queries_padded(A)
    X_dev = _scatter_dense(_upload(ids, device), _upload(vals, device), A.shape[1], float(bias))
    A._ptpu_xdev = (key, A.indptr, A.indices, A.data, X_dev)
    return X_dev


def _ranges(starts: np.ndarray, ends: np.ndarray):
    """The index ranges [starts_i, ends_i) concatenated: (which range, index)
    per element, so many clusters' slices are gathered with one fancy index."""
    lens = (ends - starts).astype(np.int64)
    rep = np.repeat(np.arange(len(starts), dtype=np.int64), lens)
    within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
    return rep, starts[rep] + within


class MLProblem(object):
    """X, Y, C, M, R of one training layer.

    M (instances x clusters) marks each instance's active clusters, whose
    labels it trains as negatives; it defaults to the teacher-forced Y @ C
    when C has more than one cluster.  R, the positives' relevance, must share
    Y's nonzero pattern and be non-negative.
    """

    def __init__(self, X, Y, C=None, M=None, R=None):
        f32 = np.float32
        self.X = X.tocsr().astype(f32) if smat.issparse(X) else np.asarray(X, dtype=f32)
        self.Y = Y.tocsc().astype(f32) if smat.issparse(Y) else smat.csc_matrix(Y, dtype=f32)
        self.Y.sort_indices()
        self.C = smat.csc_matrix(np.ones((self.Y.shape[1], 1), dtype=f32)) if C is None else C.tocsc().astype(f32)
        if R is not None:
            R = R.tocsc().astype(f32)
            R.sort_indices()
            if not (np.array_equal(self.Y.indptr, R.indptr) and np.array_equal(self.Y.indices, R.indices)):
                raise ValueError("Invalid relevance matrix: nonzero pattern differs from Y")
            if (R.data < 0).any():
                raise ValueError("Invalid relevance matrix: got value < 0")
        self.R = R
        if M is None:
            if self.C.shape[1] > 1:
                M = (self.Y @ self.C).tocsc()
            else:
                M = smat.csc_matrix(np.ones((self.Y.shape[0], 1), dtype=f32))
        elif M.shape != (self.Y.shape[0], self.C.shape[1]):
            raise ValueError("M shape mismatch")
        else:
            M = M.tocsc().astype(f32)
        self.M = M

    @property
    def nr_labels(self):
        return self.Y.shape[1]

    @property
    def nr_features(self):
        return self.X.shape[1]


def _quartiles(v: np.ndarray) -> dict:
    if len(v) == 0:
        return dict(min=0, q1=0, median=0, q3=0, max=0, mean=0.0)
    q = np.percentile(v, [0, 25, 50, 75, 100])
    return dict(min=int(q[0]), q1=int(q[1]), median=int(q[2]), q3=int(q[3]), max=int(q[4]), mean=float(np.mean(v)))


class MLModel(pecos_tpu_torch.BaseClass):
    """One tree layer: weight matrix W (D+bias, L) CSC + cluster matrix C (L, K),
    trained and predicted on ``device``."""

    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        threshold: float = 0.1
        max_nonzeros_per_label: Optional[int] = None
        solver_type: str = "L2R_L2LOSS_SVC_DUAL"
        Cp: float = 1.0
        Cn: float = 1.0
        max_iter: int = 100  # the reference's dual-solver settings, kept so params files load
        eps: float = 0.1
        bias: float = 1.0
        threads: int = -1  # the reference's OpenMP threads, kept likewise
        verbose: int = 0
        newton_eps: float = 0.01
        max_newton_iter: int = 20
        cg_max_iter: int = 10
        solver_mode: str = "auto"  # auto | dense | bucketed

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

    @classmethod
    def train(
        cls,
        prob: MLProblem,
        train_params: Optional["MLModel.TrainParams"] = None,
        pred_params: Optional["MLModel.PredParams"] = None,
        device: DeviceLike = "cuda",
        **kwargs,
    ) -> "MLModel":
        """Train one layer on ``device``; kwargs override train_params fields.

        Each label's active rows: the rows of M's column for the label's
        cluster are negatives, the rows of Y's column positives; a positive
        costs Cp (times its relevance), a negative Cn.  ``solver_mode`` auto
        solves masked dense label blocks when they fit and the layer is
        dense-ish (one cluster, or active pairs above a quarter of N x K),
        and gathers each cluster otherwise.
        """
        device = resolve_device(device)
        train_params = cls.TrainParams.from_dict(train_params)
        train_params.override_with_kwargs(kwargs)
        pred_params = cls.PredParams.from_dict(pred_params)
        loss = solvers.loss_name(train_params.solver_type)
        X, Y, C, M = prob.X, prob.Y, prob.C, prob.M
        (N, D), L, K = X.shape, Y.shape[1], C.shape[1]
        mode = train_params.solver_mode
        if mode == "auto":
            dense_fits = N * L <= (1 << 28) and N * (D + 1) <= (1 << 28)
            dense_ish = K <= 1 or (M.nnz + Y.nnz) / max(1, N * K) > 0.25
            mode = "dense" if dense_fits and dense_ish else "bucketed"
        if mode not in ("dense", "bucketed"):
            raise ValueError(f"solver_mode must be auto, dense or bucketed, got {train_params.solver_mode!r}")
        solve_kw = dict(
            loss=loss, eps=train_params.newton_eps, max_newton=train_params.max_newton_iter,
            cg_max=train_params.cg_max_iter,
        )
        train = cls._train_dense if mode == "dense" else cls._train_bucketed
        W = train(prob, train_params, solve_kw, device)
        return cls(W=W, C=C, bias=train_params.bias, pred_params=pred_params, device=device)

    @staticmethod
    def _train_dense(prob: MLProblem, tp: "MLModel.TrainParams", solve_kw: dict, device) -> smat.csc_matrix:
        """Masked dense solves over blocks of labels: X (N, Db) stays on the
        device, each block's y/c travel as one uint8 code per (row, label)
        (0 inactive, 1 positive, 2 negative).  The block is sized to the
        layer (a power of two, at most 2048 and ``_SOLVER_BLOCK_BUDGET / N``),
        pad columns stay code 0 and solve to w = 0."""
        X_dev = _dense_X_device(prob.X, tp.bias, device)
        N, Db = X_dev.shape
        L = prob.Y.shape[1]
        parents = prob.C.tocsr().indices.astype(np.int64)  # one cluster per label
        M_csc, Y_csc = prob.M.tocsc(), prob.Y.tocsc()
        R_csc = None if prob.R is None else prob.R.tocsc()
        block = max(8, min(2048, _SOLVER_BLOCK_BUDGET // max(N, 1), _pow2(L)))
        max_nnz = min(tp.max_nonzeros_per_label or Db, Db)
        thr = float(tp.threshold)
        W_cols: List[smat.csc_matrix] = []
        pending: deque = deque()  # (W block on the device, its real width), in block order

        def retire(limit: int) -> None:
            # prune on the device (threshold, then the max_nnz largest |w| per
            # label) and fetch the sparse (idx, val) pairs, not the dense block
            while len(pending) > limit:
                Wb, Lb = pending.popleft()
                K = min(max_nnz, int(solvers.count_above_threshold(Wb, thr))) if thr > 0 else max_nnz
                if K < Db // 2:
                    # a power-of-two K keeps few shapes; the top-K is sorted by
                    # magnitude, so cutting it to K keeps max_nnz exact
                    idx, vals = solvers.prune_topk_device(Wb, thr, min(_pow2(K), Db))
                    idx, vals = idx.cpu().numpy()[:Lb, :K], vals.cpu().numpy()[:Lb, :K]
                    nz = vals.ravel() != 0
                    cols = np.repeat(np.arange(Lb), idx.shape[1])[nz]
                    W_cols.append(smat.csc_matrix((vals.ravel()[nz], (idx.ravel()[nz], cols)), shape=(Db, Lb)))
                else:
                    Wh = Wb[:, :Lb].cpu().numpy()
                    W_cols.append(smat.csc_matrix(np.where(np.abs(Wh) < thr, 0.0, Wh)))

        for s in range(0, L, block):
            e = min(s + block, L)
            codes = np.zeros((N, block), np.uint8)
            codes[:, : e - s][M_csc[:, parents[s:e]].toarray() != 0] = 2
            codes[:, : e - s][Y_csc[:, s:e].toarray() > 0] = 1
            R_dev = None
            if R_csc is not None:
                Rb = np.zeros((N, block), np.float32)
                Rb[:, : e - s] = R_csc[:, s:e].toarray()
                R_dev = _upload(Rb, device)
            Wb = solvers.solve_block_coded(X_dev, _upload(codes, device), tp.Cp, tp.Cn, R_dev, **solve_kw)
            pending.append((Wb, e - s))
            retire(2)  # the next block's host work overlaps this solve
        retire(0)
        return smat_util.hstack_csc(W_cols) if W_cols else smat.csc_matrix((Db, 0), dtype=np.float32)

    @staticmethod
    def _train_bucketed(prob: MLProblem, tp: "MLModel.TrainParams", solve_kw: dict, device) -> smat.csc_matrix:
        """Per-cluster training: each cluster's active rows and the features
        they touch are gathered, and clusters of one padded shape (P2 rows,
        F2 features, xc2 nonzeros a row, powers of two) are solved together
        by :func:`solvers.solve_cluster_bucket`.  Clusters whose padded P x F
        exceeds ``_LOCAL_DENSE_BUDGET`` go to :func:`solvers.solve_sparse_rows`
        in the global feature space.  All bookkeeping is vectorised over the
        whole layer (one SpMM for the active sets, one sort for the feature
        unions), not a Python loop per cluster or label."""
        X = prob.X.tocsr() if smat.issparse(prob.X) else smat.csr_matrix(prob.X)
        Y_csc, C, M_csc = prob.Y.tocsc(), prob.C.tocsc(), prob.M.tocsc()
        N, D = X.shape
        L, K = Y_csc.shape[1], C.shape[1]
        bias = tp.bias
        nb = 1 if bias > 0 else 0
        Db = D + nb
        max_nnz = tp.max_nonzeros_per_label or Db
        Cp, Cn = np.float32(tp.Cp), np.float32(tp.Cn)

        # the tree: cluster k's labels are C's column k; a label's sibling rank is its place there
        c_indptr = C.indptr
        nk_all = np.diff(c_indptr)
        parents = np.zeros(L, np.int64)
        parents[C.indices] = np.repeat(np.arange(K), nk_all)
        j_local = np.empty(L, np.int64)
        j_local[C.indices] = np.arange(len(C.indices)) - np.repeat(c_indptr[:-1], nk_all)
        ns_max = max(int(nk_all.max()) if K else 1, 1)

        # active rows of every cluster: the pattern of Y @ C + M, CSC by cluster
        Act = (smat_util.binarized(Y_csc) @ smat_util.binarized(C) + smat_util.binarized(M_csc)).tocsc()
        Act.sum_duplicates()
        Act.sort_indices()
        act_indptr, act_rows = Act.indptr, Act.indices
        P_arr = np.diff(act_indptr)
        act_cluster = np.repeat(np.arange(K, dtype=np.int64), P_arr)
        act_keys = act_cluster * N + act_rows  # sorted: by cluster, then row
        in_M = np.zeros(len(act_rows), bool)
        m_cluster = np.repeat(np.arange(K, dtype=np.int64), np.diff(M_csc.indptr))
        in_M[np.searchsorted(act_keys, m_cluster * N + M_csc.indices)] = True

        # positives: (local row, sibling rank, cost) per Y entry, grouped by cluster
        y_lab = np.repeat(np.arange(L, dtype=np.int64), np.diff(Y_csc.indptr))
        y_par = parents[y_lab]
        y_cost = Cp * prob.R.tocsc().data.astype(np.float32) if prob.R is not None else np.full(len(y_lab), Cp, np.float32)
        ordY = np.argsort(y_par, kind="stable")
        y_row = (np.searchsorted(act_keys, y_par * N + Y_csc.indices) - act_indptr[y_par])[ordY]
        y_j, y_cost = j_local[y_lab][ordY], y_cost[ordY]
        y_bounds = np.searchsorted(y_par[ordY], np.arange(K + 1))

        # one global gather of the active rows of X, one entry list per cluster
        XA = X[act_rows]
        row_nnz = np.diff(XA.indptr)
        e_cluster = np.repeat(act_cluster, row_nnz)
        e_row = np.repeat(np.arange(len(act_rows)) - act_indptr[act_cluster], row_nnz)  # local row
        e_off = np.arange(XA.nnz) - np.repeat(XA.indptr[:-1], row_nnz)  # slot within its row
        xent_bounds = np.searchsorted(e_cluster, np.arange(K + 1))
        seg_nnz = np.bincount(e_cluster, minlength=K)
        xcap_arr = np.zeros(K, np.int64)
        np.maximum.at(xcap_arr, act_cluster, row_nnz)
        xcap_arr += nb

        pw2_P = _pow2(P_arr)
        is_big = (pw2_P * _pow2(np.minimum(seg_nnz + 1, Db), lo=128) > _LOCAL_DENSE_BUDGET) & (P_arr > 0)
        nonempty = (P_arr > 0) & (nk_all > 0)
        small = nonempty & ~is_big

        # feature unions of the small clusters: one sort of (cluster, feature)
        # keys; the bias feature D is every union's largest key, so its last slot
        stride = np.int64(D + 1)
        e_small = small[e_cluster]
        fkeys = e_cluster[e_small] * stride + XA.indices[e_small]
        small_ids = np.nonzero(small)[0].astype(np.int64)
        uniq = np.unique(np.concatenate([fkeys, small_ids * stride + D]) if nb else fkeys)
        F_bounds = np.searchsorted(uniq, np.arange(K + 1, dtype=np.int64) * stride)
        F_len = np.diff(F_bounds)
        F_feat = uniq % stride
        f_local = np.zeros(XA.nnz, np.int32)
        f_local[e_small] = np.searchsorted(uniq, fkeys) - F_bounds[e_cluster[e_small]]

        def prune(Wb: np.ndarray) -> np.ndarray:
            """Threshold, then keep the max_nnz largest |w| of each label
            (axis -2 is the feature axis)."""
            Wb = np.where(np.abs(Wb) < tp.threshold, 0.0, Wb)
            if max_nnz < Wb.shape[-2]:
                top = np.take(np.argpartition(-np.abs(Wb), max_nnz - 1, axis=-2), np.arange(max_nnz), axis=-2)
                keep = np.zeros(Wb.shape, bool)
                np.put_along_axis(keep, top, True, axis=-2)
                Wb = np.where(keep, Wb, 0.0)
            return Wb

        W_rows: List[np.ndarray] = []
        W_cols: List[np.ndarray] = []
        W_vals: List[np.ndarray] = []
        # solves in flight: each finishes (fetch, prune, scatter into W) in
        # order once the window is full, so host padding of the next chunk
        # overlaps the device's work on this one
        pending: deque = deque()

        def retire(limit: int) -> None:
            while len(pending) > limit:
                finish, dev = pending.popleft()
                finish(dev.cpu().numpy())

        # small clusters, bucketed by padded shape and chunked to bound device memory
        F2_arr, xc2_arr = _pow2(F_len, lo=128), _pow2(xcap_arr)
        small_ids = small_ids[np.lexsort((xc2_arr[small_ids], F2_arr[small_ids], pw2_P[small_ids]))]
        shape_key = np.stack([pw2_P[small_ids], F2_arr[small_ids], xc2_arr[small_ids]], axis=1)
        new_shape = np.ones(len(small_ids), bool)
        new_shape[1:] = np.any(shape_key[1:] != shape_key[:-1], axis=1)
        starts = np.flatnonzero(new_shape)
        for b0, b1 in zip(starts, np.r_[starts[1:], len(small_ids)]):
            P2, F2, xc2 = (int(v) for v in shape_key[b0])
            cb = max(1, _BUCKET_CHUNK_ELEMENTS // (P2 * F2))
            for s in range(b0, b1, cb):
                ks = small_ids[s : min(s + cb, b1)]
                Cb = len(ks)
                ids = np.full((Cb, P2, xc2), F2, np.int32)
                vals = np.zeros((Cb, P2, xc2), np.float32)
                rep, ei = _ranges(xent_bounds[ks], xent_bounds[ks + 1])
                ids[rep, e_row[ei], e_off[ei]] = f_local[ei]
                vals[rep, e_row[ei], e_off[ei]] = XA.data[ei]
                rep, ai = _ranges(act_indptr[ks], act_indptr[ks + 1])
                p_local = ai - act_indptr[ks][rep]
                if nb:
                    ids[rep, p_local, row_nnz[ai]] = (F_len[ks] - 1)[rep]
                    vals[rep, p_local, row_nnz[ai]] = bias
                active = np.zeros((Cb, P2), bool)
                active[rep, p_local] = True
                negative = np.zeros((Cb, P2), bool)
                negative[rep, p_local] = in_M[ai]
                nk = nk_all[ks]
                # pad rows are positives at cost 0; real rows negatives at Cn where M marks them
                yb = np.repeat(np.where(active, np.float32(-1.0), np.float32(1.0))[:, :, None], ns_max, axis=2)
                col_ok = np.arange(ns_max)[None, None, :] < nk[:, None, None]
                cb_ = np.where(col_ok & negative[:, :, None], Cn, np.float32(0.0))
                rep, yi = _ranges(y_bounds[ks], y_bounds[ks + 1])
                yb[rep, y_row[yi], y_j[yi]] = 1.0
                cb_[rep, y_row[yi], y_j[yi]] = y_cost[yi]
                Wl = solvers.solve_cluster_bucket(
                    *(_upload(a, device) for a in (ids, vals, yb, cb_)), F2=F2, **solve_kw
                )

                def finish_bucket(Wl, ks=ks, nk=nk):
                    ci, fi, ji = np.nonzero(prune(Wl))  # (Cb, F2, ns_max)
                    keep = (fi < F_len[ks][ci]) & (ji < nk[ci])
                    ci, fi, ji = ci[keep], fi[keep], ji[keep]
                    W_rows.append(F_feat[F_bounds[ks[ci]] + fi])
                    W_cols.append(C.indices[c_indptr[ks[ci]] + ji].astype(np.int64))
                    W_vals.append(Wl[ci, fi, ji])

                pending.append((finish_bucket, Wl))
                retire(6)

        # big clusters: the global sparse-rows solver, one cluster at a time
        for k in np.flatnonzero(nonempty & is_big):
            P, xcap = int(P_arr[k]), max(int(xcap_arr[k]), 1)
            P2, xc2, nk = _pow2(P), _pow2(xcap), int(nk_all[k])
            ids = np.full((P2, xc2), Db, np.int32)
            vals = np.zeros((P2, xc2), np.float32)
            ei = np.arange(xent_bounds[k], xent_bounds[k + 1])
            ids[e_row[ei], e_off[ei]] = XA.indices[ei]
            vals[e_row[ei], e_off[ei]] = XA.data[ei]
            if nb:
                seg = row_nnz[act_indptr[k] : act_indptr[k + 1]]
                ids[np.arange(P), seg] = D
                vals[np.arange(P), seg] = bias
            yb = np.ones((P2, nk), np.float32)
            cb_ = np.zeros((P2, nk), np.float32)
            yb[:P] = -1.0
            cb_[:P] = np.where(in_M[act_indptr[k] : act_indptr[k + 1]], Cn, np.float32(0.0))[:, None]
            yi = np.arange(y_bounds[k], y_bounds[k + 1])
            yb[y_row[yi], y_j[yi]] = 1.0
            cb_[y_row[yi], y_j[yi]] = y_cost[yi]
            Wg = solvers.solve_sparse_rows(*(_upload(a, device) for a in (ids, vals, yb, cb_)), Db=Db, **solve_kw)

            def finish_big(Wg, k=k):
                fi, ji = np.nonzero(prune(Wg))  # (Db, nk)
                W_rows.append(fi.astype(np.int64))
                W_cols.append(C.indices[c_indptr[k] + ji].astype(np.int64))
                W_vals.append(Wg[fi, ji])

            pending.append((finish_big, Wg))
            retire(2)
        retire(0)

        cat = lambda parts, dtype: np.concatenate(parts) if parts else np.zeros(0, dtype)
        return smat.csc_matrix(
            (cat(W_vals, np.float32), (cat(W_rows, np.int64), cat(W_cols, np.int64))), shape=(Db, L)
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
    """Chain of MLModels forming the hierarchical linear model; trains and
    predicts on the device its layers share."""

    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        neg_mining_chain: Union[str, Sequence[str]] = "tfn"
        model_chain: Any = None  # MLModel.TrainParams, or a tuple of them, one per layer

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

    @staticmethod
    def _broadcast_chain_params(params, param_cls, depth: int):
        """``params`` (None, a dict or a ``param_cls``) with ``model_chain``
        expanded to a tuple of ``depth`` leaf params: None gives defaults, one
        leaf (alone or in a sequence of one) is copied to every layer."""
        leaf_cls = MLModel.TrainParams if param_cls is HierarchicalMLModel.TrainParams else MLModel.PredParams
        params = param_cls.from_dict(params)
        mc = params.model_chain
        if mc is None:
            mc = [leaf_cls()]
        elif isinstance(mc, (leaf_cls, dict)):
            mc = [mc]
        mc = tuple(leaf_cls.from_dict(p) for p in mc)
        if len(mc) == 1:
            mc = tuple(copy.deepcopy(mc[0]) for _ in range(depth))
        if len(mc) != depth:
            raise ValueError(f"model_chain length {len(mc)} != depth {depth}")
        params.model_chain = mc
        return params

    @classmethod
    def train(
        cls,
        prob: MLProblem,
        clustering: Optional[ClusterChain] = None,
        train_params: Optional["HierarchicalMLModel.TrainParams"] = None,
        pred_params: Optional["HierarchicalMLModel.PredParams"] = None,
        matching_chain=None,
        relevance_chain=None,
        device: DeviceLike = "cuda",
        **kwargs,
    ) -> "HierarchicalMLModel":
        """Layer-by-layer training on ``device``.  Y is rolled up the chain;
        layer t trains its labels against the negatives its scheme mines:
        ``tfn`` the clusters of the instance's own labels (teacher-forced),
        ``man`` the clusters the layer above predicts for it (matcher-aware),
        ``usn`` ``matching_chain[t]`` (user-supplied).  kwargs: ``pred_kwargs``
        overrides every layer's pred params."""
        device = resolve_device(device)
        if clustering is None:
            clustering = ClusterChain([prob.C])
        elif not isinstance(clustering, ClusterChain):
            clustering = ClusterChain(clustering)
        depth = len(clustering)
        train_params = cls._broadcast_chain_params(train_params, cls.TrainParams, depth)
        schemes = train_params.neg_mining_chain or "tfn"
        schemes = [schemes] * depth if isinstance(schemes, str) else list(schemes)
        train_params.neg_mining_chain = schemes = [s.lower() for s in schemes]
        if len(schemes) != depth:
            raise ValueError("neg_mining_chain length mismatch")
        pred_params = cls._broadcast_chain_params(pred_params, cls.PredParams, depth)
        pred_params.override_with_kwargs(kwargs.get("pred_kwargs"))

        Y_chain = [prob.Y.tocsc()]  # Y_t = Y_{t+1} @ C_{t+1}
        for C in clustering[:0:-1]:
            Y_chain.insert(0, (Y_chain[0] @ C).tocsc())
        matching_chain = [None] * depth if matching_chain is None else list(matching_chain)
        relevance_chain = [None] * depth if relevance_chain is None else list(relevance_chain)

        model_chain: List[MLModel] = []
        M_pred = None  # the layer above's predictions, for man
        for t, (Y, C, scheme) in enumerate(zip(Y_chain, clustering, schemes)):
            LOGGER.info(f"training layer {t + 1}/{depth} (labels={Y.shape[1]}, neg_mining={scheme})")
            M = None  # the top layer of one cluster trains every row against every label
            if t > 0 or C.shape[1] > 1:
                M = smat.csc_matrix((Y.shape[0], C.shape[1]), dtype=np.float32)
                if "usn" in scheme and matching_chain[t] is not None:
                    M = M + smat_util.binarized(matching_chain[t])
                if "tfn" in scheme:
                    M = M + smat_util.binarized(Y_chain[t - 1] if t > 0 else Y @ C)
                if t > 0 and any("man" in s for s in schemes[t:]):
                    M_pred = model_chain[-1].predict(prob.X, csr_codes=M_pred)
                if t > 0 and "man" in scheme:
                    M = M + smat_util.binarized(M_pred)
            layer_prob = MLProblem(prob.X, Y, C=C, M=M, R=relevance_chain[t])
            model_chain.append(
                MLModel.train(
                    layer_prob, train_params=train_params.model_chain[t],
                    pred_params=pred_params.model_chain[t], device=device,
                )
            )
        return cls(model_chain, pred_params=pred_params)

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
