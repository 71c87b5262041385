"""Beam-search inference engine for hierarchical linear models, in PyTorch.

The port of ``pecos_tpu/xmc/inference.py``: the same static-shape beam search
over padded children tables, run eagerly on one torch device.

- A layer lives on the device in one of two layouts (:class:`DeviceLayer`):
  ``dense`` — W as a dense (D+1, L) matrix, for the small upper levels; or
  ``plabel`` — every label's pruned sparse weight vector padded to P slots and
  packed as [ids | float bits], plus ``parent_packed``, the same rows grouped
  by parent so one beam parent's children are one gathered row.
- One beam step expands the beam's parents into candidates, scores them,
  applies the post-processor's transform and combiner, masks invalid
  candidates and keeps the top k.
- plabel layers score sparse queries with K1 (``pecos_tpu_torch.ops.intersect``),
  the CUDA kernel on a GPU and its plain version on the CPU.

Left out of this port so far, each listed in ROADMAP.md: the uint16 wire codec
(queries travel as padded int32 ids + float32 values, which equals the JAX
package's default float32 wire bit for bit), ``RealtimeSession``, the compiled
mmap model (``save_compiled_layers``/``load_compiled_layers``,
``MmapCompiledHierModel``) and ``single_layer_predict``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as smat
import torch

from pecos_tpu_torch.ops.intersect import intersect_scores, split_packed
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.cluster_util import padded_children
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device
from .postprocessor import PostProcessor

NEG_INF = -1e30
# layers whose dense W would exceed this many elements use the plabel layout
DENSE_LAYOUT_MAX_ELEMENTS = 1 << 24


@dataclasses.dataclass
class DeviceLayer:
    """One model layer resident on a torch device."""

    kind: str  # "dense" | "plabel"
    nr_labels: int
    children: torch.Tensor  # (n_parents, max_children) int64, -1 padded
    W: Optional[torch.Tensor] = None  # dense: (D+1, L) float32
    packed: Optional[torch.Tensor] = None  # plabel: (L, 2P) int32 [ids | float bits]
    # plabel: (n_parents, max_children, 2P) int32 — each parent's children's
    # packed rows in children-table order (zeros for -1 children), so scoring a
    # beam gathers one row per parent instead of one per candidate
    parent_packed: Optional[torch.Tensor] = None

    @property
    def max_children(self) -> int:
        return self.children.shape[1]

    @property
    def device(self) -> torch.device:
        return self.children.device

    def to(self, device: DeviceLike) -> "DeviceLayer":
        dev = resolve_device(device)
        move = lambda t: None if t is None else t.to(dev)
        return DeviceLayer(
            self.kind, self.nr_labels, move(self.children), move(self.W),
            move(self.packed), move(self.parent_packed),
        )


def build_parent_packed(packed: np.ndarray, children: np.ndarray) -> np.ndarray:
    """Host-side (n_parents, maxc, 2P) layout: packed rows of each parent's
    children, zeros where the children table is -1 padded."""
    pp = np.asarray(packed)[np.clip(children, 0, packed.shape[0] - 1)]
    pp[np.asarray(children) < 0] = 0
    return pp


def _plabel_packed(W: smat.csc_matrix) -> np.ndarray:
    """(L, 2P) int32 [ids | float bits] with P the max column nnz rounded up to 8."""
    L = W.shape[1]
    nnz = np.diff(W.indptr)
    cap = max(8, -(-int(nnz.max() if L else 0) // 8) * 8)
    ids = np.zeros((L, cap), dtype=np.int32)
    vals = np.zeros((L, cap), dtype=np.float32)
    rows = np.repeat(np.arange(L), nnz)
    offs = np.arange(W.nnz) - np.repeat(W.indptr[:-1], nnz)
    ids[rows, offs] = W.indices
    vals[rows, offs] = W.data
    return np.concatenate([ids, vals.view(np.int32)], axis=1)


def build_device_layer(
    W: smat.spmatrix,
    C: smat.spmatrix,
    *,
    layout: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> DeviceLayer:
    """Device layout for one layer from host CSC W (D+1, L) and C (L, n_parents)."""
    W = W.tocsc()
    n_feat_b, L = W.shape
    children, _ = padded_children(C)
    if layout is None:
        layout = "dense" if n_feat_b * L <= DENSE_LAYOUT_MAX_ELEMENTS else "plabel"
    if layout == "dense":
        arrays = {"W": np.asarray(W.todense(), dtype=np.float32)}
    elif layout == "plabel":
        packed = _plabel_packed(W)
        arrays = {"packed": packed, "parent_packed": build_parent_packed(packed, children)}
    else:
        raise ValueError(f"unknown layout {layout!r}")
    return layers_from_numpy(
        [{"kind": layout, "nr_labels": L, "children": children, **arrays}], device
    )[0]


def layers_from_numpy(layers: Sequence[Dict], device: DeviceLike) -> List[DeviceLayer]:
    """DeviceLayers from numpy arrays named like the DeviceLayer fields (kind,
    nr_labels, children, W | packed [, parent_packed]); the JAX package's
    layers, passed through ``np.asarray``, carry over as they are.  A plabel
    layer without parent_packed scores from per-label packed rows."""
    dev = resolve_device(device)
    # copies: the tensors own their memory even where the arrays are read-only views
    tensor = lambda a, dtype: torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(dev)
    out = []
    for d in layers:
        children = tensor(d["children"], np.int64)
        if d["kind"] == "dense":
            out.append(DeviceLayer("dense", int(d["nr_labels"]), children, W=tensor(d["W"], np.float32)))
        elif d["kind"] == "plabel":
            pp = d.get("parent_packed")
            out.append(
                DeviceLayer(
                    "plabel",
                    int(d["nr_labels"]),
                    children,
                    packed=tensor(d["packed"], np.int32),
                    parent_packed=None if pp is None else tensor(pp, np.int32),
                )
            )
        else:
            raise ValueError(f"unknown layer kind {d['kind']!r}")
    return out


def prepare_queries(X, bias: float) -> np.ndarray:
    """Dense (N, D+1) query block with the bias column appended."""
    Xd = np.asarray(X.todense() if smat.issparse(X) else X, dtype=np.float32)
    if bias > 0:
        Xd = np.hstack([Xd, np.full((Xd.shape[0], 1), bias, dtype=np.float32)])
    return Xd


def prepare_queries_padded(X: smat.spmatrix, cap: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse queries as padded (ids int32, vals float32), each (N, cap).

    Id D+1 with value 0 marks padding.  ``cap`` defaults to the max row nnz
    rounded up to a power of two, at least 64.
    """
    A = X.tocsr()
    nnz = np.diff(A.indptr)
    if cap is None:
        max_nnz = int(nnz.max()) if A.shape[0] else 1
        cap = max(64, 1 << (max_nnz - 1).bit_length())
    D = A.shape[1]
    if A.shape[0] and A.nnz == A.shape[0] * cap and int(nnz.max()) == cap:
        # every row full: the padded layout is a reshape of the CSR arrays
        return (
            np.ascontiguousarray(A.indices.reshape(A.shape[0], cap), np.int32),
            np.ascontiguousarray(A.data.reshape(A.shape[0], cap), np.float32),
        )
    ids = np.full((A.shape[0], cap), D + 1, dtype=np.int32)
    vals = np.zeros((A.shape[0], cap), dtype=np.float32)
    rows = np.repeat(np.arange(A.shape[0]), nnz)
    offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz)
    ids[rows, offs] = A.indices
    vals[rows, offs] = A.data
    return ids, vals


def scatter_queries(ids: torch.Tensor, vals: torch.Tensor, D: int, bias: float) -> torch.Tensor:
    """Densify padded queries on the device: (B, cap) -> (B, D+1) with bias.

    One scatter-add into a (B, D+2) buffer: column D holds the bias feature,
    column D+1 takes the padding and is cut off.  Ids lie in [0, D-1] or are
    D+1 by construction (``prepare_queries_padded``), so none is out of range.
    """
    X = torch.zeros((ids.shape[0], D + 2), dtype=torch.float32, device=ids.device)
    X.scatter_add_(1, ids.long(), vals)
    if bias > 0:
        X[:, D] = bias
    return X[:, : D + 1]


def score_candidates_dense_sparse(
    qids: torch.Tensor,  # (N, Qn) int32, pad id >= D+1 with val 0
    qvals: torch.Tensor,  # (N, Qn) float32
    layer: DeviceLayer,
    cand: torch.Tensor,  # (N, K) int64, in range
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> torch.Tensor:
    """Dense-layout layer scored from sparse queries: a row gather of W and one
    contraction, scores[b, l] = sum_q qvals[b, q] * W[qids[b, q], l].  Padded
    qids clip onto the last row; their vals are 0 so they add nothing."""
    W = layer.W  # (D+1, L)
    Wg = W[qids.long().clamp(0, W.shape[0] - 1)]  # (N, Qn, L)
    scores_all = torch.einsum("bql,bq->bl", Wg, qvals)
    if bias_id is not None:
        scores_all = scores_all + bias_val * W[bias_id]
    return scores_all.gather(1, cand)


def score_candidates(X: torch.Tensor, layer: DeviceLayer, cand: torch.Tensor) -> torch.Tensor:
    """Raw scores x . w_l for candidate labels from dense queries X (N, D+1)."""
    if layer.kind == "dense":
        return (X @ layer.W).gather(1, cand)
    N, K = cand.shape
    ids, vals = split_packed(layer.packed[cand])  # (N, K, P)
    xg = X.gather(1, ids.reshape(N, -1).long()).reshape(ids.shape)
    return (xg * vals).sum(dim=-1)


def score_candidates_sparse(
    qids: torch.Tensor,
    qvals: torch.Tensor,
    layer: DeviceLayer,
    cand: torch.Tensor,  # (N, K) int64, in range
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> torch.Tensor:
    """Sparse-query x sparse-weight candidate scoring (K1) from the per-label
    packed rows: one gathered (2P) row per candidate."""
    return intersect_scores(qids, qvals, layer.packed[cand], bias_id, bias_val)


def score_candidates_sparse_parents(
    qids: torch.Tensor,
    qvals: torch.Tensor,
    layer: DeviceLayer,
    parents: torch.Tensor,  # (N, Bm) int64, in range
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> torch.Tensor:
    """K1 from the parent-packed layout: one gathered row per beam parent
    covers all its children.  Returns (N, Bm*maxc) raw scores aligned with
    ``children[parents].reshape(N, -1)``."""
    N = parents.shape[0]
    w = layer.parent_packed[parents].reshape(N, -1, layer.parent_packed.shape[2])
    return intersect_scores(qids, qvals, w, bias_id, bias_val)


def beam_step(
    X: Optional[torch.Tensor],
    layer: DeviceLayer,
    parents: torch.Tensor,  # (N, B) int64 node ids at the previous level (-1 invalid)
    pvals: torch.Tensor,  # (N, B) float32 combined path values
    k: int,
    pp: PostProcessor,
    no_prev: bool,
    qids: Optional[torch.Tensor] = None,
    qvals: Optional[torch.Tensor] = None,
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand parents through one layer; returns (labels (N, k), values (N, k))."""
    N, B = parents.shape
    maxc = layer.max_children
    safe_parents = parents.clamp(0, layer.children.shape[0] - 1)
    cand = layer.children[safe_parents].reshape(N, B * maxc)
    valid = (cand >= 0) & (parents >= 0).repeat_interleave(maxc, dim=1)
    cand_safe = cand.clamp(0, layer.nr_labels - 1)
    if layer.kind == "plabel" and qids is not None:
        if layer.parent_packed is not None:
            raw = score_candidates_sparse_parents(qids, qvals, layer, safe_parents, bias_id, bias_val)
        else:
            raw = score_candidates_sparse(qids, qvals, layer, cand_safe, bias_id, bias_val)
    elif layer.kind == "dense" and X is None:
        raw = score_candidates_dense_sparse(qids, qvals, layer, cand_safe, bias_id, bias_val)
    else:
        raw = score_candidates(X, layer, cand_safe)
    val = pp.transform_torch(raw)
    if not no_prev:
        val = pp.combiner_torch(val, pvals.repeat_interleave(maxc, dim=1))
    val = torch.where(valid, val, NEG_INF)
    k = min(k, B * maxc)
    # jax.lax.top_k puts the lower index first among equal values; a stable
    # descending sort does the same, so ties (saturated hinges, masked slots)
    # break alike in both packages and on every device
    topv, topi = torch.sort(val, dim=1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    labels = cand.gather(1, topi)
    labels = torch.where(topv > NEG_INF * 0.5, labels, -1)
    return labels, topv


def chain_predict(
    X: Optional[torch.Tensor],
    layers: Sequence[DeviceLayer],
    beam_size: int,
    only_topk: int,
    pp_names: Tuple[str, ...],
    qids: Optional[torch.Tensor] = None,
    qvals: Optional[torch.Tensor] = None,
    bias_id: Optional[int] = None,
    bias_val: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-chain beam search.  Returns (labels (N, k), values (N, k)).

    X is the dense (N, D+1) query block for dense layers; (qids, qvals) the
    padded sparse form for plabel layers.  Either may be None when no layer
    needs it.  ``bias_id`` (the bias feature's column) lets sparse scoring add
    the bias term without widening every query row.
    """
    ref = X if X is not None else qids
    N = ref.shape[0]
    n_roots = layers[0].children.shape[0]
    parents = torch.arange(n_roots, dtype=torch.int64, device=ref.device).repeat(N, 1)
    pvals = torch.full(
        (N, n_roots), PostProcessor.get(pp_names[0]).init_value, dtype=torch.float32, device=ref.device
    )
    for d, layer in enumerate(layers):
        k = only_topk if d == len(layers) - 1 else beam_size
        parents, pvals = beam_step(
            X, layer, parents, pvals, k, PostProcessor.get(pp_names[d]), no_prev=(d == 0),
            qids=qids, qvals=qvals, bias_id=bias_id, bias_val=bias_val,
        )
    return parents, pvals


class CompiledHierModel:
    """Device-resident hierarchical model: the layers of one chain on one
    torch device, and the batched beam-search predict over them."""

    def __init__(self, layers: List[DeviceLayer], bias: float, nr_features: int):
        devices = {l.device for l in layers}
        if len(devices) != 1:
            raise ValueError(f"all layers must be on one device, got {sorted(map(str, devices))}")
        self.layers = layers
        self.bias = bias
        self.nr_features = nr_features
        self.device = devices.pop()

    @classmethod
    def from_host_chain(
        cls,
        Ws: Sequence[smat.spmatrix],
        Cs: Sequence[smat.spmatrix],
        bias: float,
        *,
        layouts: Optional[Sequence[Optional[str]]] = None,
        device: DeviceLike = "cuda",
    ) -> "CompiledHierModel":
        layouts = layouts if layouts is not None else [None] * len(Ws)
        layers = [
            build_device_layer(W, C, layout=lo, device=device) for W, C, lo in zip(Ws, Cs, layouts)
        ]
        return cls(layers, bias, Ws[0].shape[0] - (1 if bias > 0 else 0))

    @property
    def nr_labels(self) -> int:
        return self.layers[-1].nr_labels

    @property
    def depth(self) -> int:
        return len(self.layers)

    def _pp_names(self, post_processor) -> Tuple[str, ...]:
        if isinstance(post_processor, str):
            names = (post_processor,) * self.depth
        else:
            names = tuple(post_processor)
        for name in names:
            PostProcessor.get(name)  # validate early with a clear error
        return names

    def uses_dense_queries(self, batch: int, cap: int) -> bool:
        """Whether sparse queries of this batch are densified on the device for
        the dense layers (the rule of the JAX package's ``_sparse_predictor``).

        Dense layers score from the sparse queries by a W-row gather when the
        densified (batch, D+2) block would be large; for small D the scatter is
        cheap.  A dense layer too wide for the gather intermediate also forces
        the scatter."""
        D = self.nr_features
        return any(l.kind == "dense" for l in self.layers) and (
            batch * (D + 2) <= (1 << 26)
            or any(l.kind == "dense" and batch * cap * l.nr_labels > (1 << 28) for l in self.layers)
        )

    def predict_padded(
        self,
        ids: torch.Tensor,
        vals: torch.Tensor,
        *,
        beam_size: int,
        only_topk: int,
        pp_names: Tuple[str, ...],
        has_dense: bool,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam search for one batch of padded sparse queries already on the
        device; returns (labels, values) on the device."""
        D = self.nr_features
        use_sparse_q = any(l.kind == "plabel" for l in self.layers) or not has_dense
        X = scatter_queries(ids, vals, D, self.bias) if has_dense else None
        return chain_predict(
            X, self.layers, beam_size, only_topk, pp_names,
            qids=ids if use_sparse_q else None,
            qvals=vals if use_sparse_q else None,
            bias_id=D if self.bias > 0 else None,
            bias_val=self.bias,
        )

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def predict(
        self,
        X,
        *,
        beam_size: int = 10,
        only_topk: int = 20,
        post_processor="l3-hinge",
        batch_size: int = 1024,
        wire_value_dtype: str = "float32",
    ) -> smat.csr_matrix:
        """Host-facing predict: any X (sparse/dense) -> sorted top-k CSR.

        ``post_processor`` is one name for every layer or a tuple of per-layer
        names.  Sparse queries travel as padded int32 ids + float32 values
        (``wire_value_dtype`` must be "float32"; the compressed wire codecs are
        not ported yet).  Each batch is prepared on the host, uploaded from
        pinned memory without blocking and run; results stay on the device
        until one concatenation and one copy to the host at the end.
        """
        if wire_value_dtype != "float32":
            raise NotImplementedError(
                f"wire_value_dtype={wire_value_dtype!r}: the compressed query wire "
                "(encode_wire_batch/decode_wire_batch) is not ported yet; see ROADMAP.md, "
                "'wire codec + RealtimeSession'"
            )
        if X.shape[1] != self.nr_features:
            raise ValueError(
                f"Feature dimension of query matrix ({X.shape[1]}) does not match "
                f"weight matrix ({self.nr_features})"
            )
        pp_names = self._pp_names(post_processor)
        N = X.shape[0]
        batch = min(batch_size, max(1, 1 << max(N - 1, 0).bit_length()))
        nb = -(-N // batch) if N else 0
        D = self.nr_features
        pending = []
        if smat.issparse(X):
            A = X.tocsr()
            max_nnz = int(np.diff(A.indptr).max()) if N else 1
            cap = max(64, 1 << max(0, max_nnz - 1).bit_length())
            has_dense = self.uses_dense_queries(batch, cap)
            for i in range(nb):
                ids_b, vals_b = prepare_queries_padded(A[i * batch : (i + 1) * batch], cap=cap)
                pad = batch - ids_b.shape[0]
                if pad:
                    ids_b = np.vstack([ids_b, np.full((pad, cap), D + 1, np.int32)])
                    vals_b = np.vstack([vals_b, np.zeros((pad, cap), np.float32)])
                pending.append(
                    self.predict_padded(
                        self._upload(ids_b), self._upload(vals_b), beam_size=beam_size,
                        only_topk=only_topk, pp_names=pp_names, has_dense=has_dense,
                    )
                )
        else:
            Xd = prepare_queries(X, self.bias)
            for i in range(nb):
                xb = Xd[i * batch : (i + 1) * batch]
                if xb.shape[0] < batch:
                    xb = np.vstack([xb, np.zeros((batch - xb.shape[0], xb.shape[1]), np.float32)])
                pending.append(
                    chain_predict(self._upload(xb), self.layers, beam_size, only_topk, pp_names)
                )
        if pending:
            labels = torch.cat([l for l, _ in pending]).cpu().numpy()[:N]
            vals = torch.cat([v for _, v in pending]).cpu().numpy()[:N]
        else:
            labels = np.zeros((0, only_topk), np.int64)
            vals = np.zeros((0, only_topk), np.float32)
        return smat_util.csr_from_topk_arrays(labels, vals, self.nr_labels)
