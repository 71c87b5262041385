"""A (dp, lp) mesh of torch devices, and XR-Linear's sharded solve and predict.

The port of ``pecos_tpu/parallel/mesh.py``.  A ``jax.sharding.Mesh`` is
single-controller: one process drives every device of the mesh and XLA adds
the collectives.  :class:`Mesh` is its counterpart here: one process holds a
(dp, lp) grid of ``torch.device`` and runs each shard's work on the shard's
own device, moving the small per-level results between devices itself.

- ``dp``: queries (rows of X), data parallel.  A solve's X^T G contractions
  are summed over it, in row-shard order.
- ``lp``: labels, model parallel, the counterpart of the reference's sub-tree
  model parallelism.  Each device holds 1/lp of every layer's weights; at
  predict every level's candidate scores are gathered over lp (the JAX
  package's ``lax.pmax``) and the top-k runs once per dp group.

A device may appear more than once in a mesh: a list of the CPU repeated is
the counterpart of jax's virtual CPU devices, and one card repeated runs every
shard's code path on that card.  On CUDA devices the sparse engine scores
every plabel level with K1 (``ops.intersect.intersect_scores_rows``), once
per shard, or raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as smat
import torch
import torch.nn.functional as F

from pecos_tpu_torch.ops.intersect import intersect_scores_rows
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device
from pecos_tpu_torch.xmc import solvers
from pecos_tpu_torch.xmc.inference import (
    NEG_INF,
    DeviceLayer,
    _check_features,
    _fetch_topk,
    _pp_names,
    _upload,
    build_parent_packed,
    chain_predict,
    expand_beam,
    pad_query_rows,
    prepare_queries,
    prepare_queries_padded,
    root_beam,
    score_candidates,
    score_candidates_dense_sparse,
    select_beam,
)
from pecos_tpu_torch.xmc.postprocessor import PostProcessor


class Mesh:
    """A (dp, lp) grid of torch devices driven by one process.  ``devices[i][j]``
    holds row block i of the queries and label block j of the model;
    ``shape`` is ``{"dp": dp, "lp": lp}``, as ``jax.sharding.Mesh`` gives it."""

    def __init__(self, devices: Sequence[Sequence[DeviceLike]]):
        grid = tuple(tuple(resolve_device(d) for d in row) for row in devices)
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        self.devices: Tuple[Tuple[torch.device, ...], ...] = grid
        self.shape = {"dp": len(grid), "lp": len(grid[0])}

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["lp"]


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A (dp, lp) mesh over the first ``n_devices`` of ``devices`` (default:
    every CUDA card).  dp defaults to the largest power of two with
    dp * dp * 2 <= n, so both axes grow; lp = n // dp."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu'] * n for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} devices asked for, {len(devices)} given")
    if dp is None:
        dp = 1
        while dp * dp * 2 <= n:
            dp *= 2
    if not 1 <= dp <= n:
        raise ValueError(f"make_mesh: dp={dp} does not fit {n} devices")
    lp = n // dp
    return Mesh([devices[i * lp : (i + 1) * lp] for i in range(dp)])


def cuda_devices(n: int) -> List[torch.device]:
    """n devices for a mesh of n shards on the cards there are: the first n
    cards, or card 0 repeated n times when there are fewer."""
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not cards:
        raise RuntimeError("cuda_devices: no CUDA device")
    return cards[:n] if len(cards) >= n else [cards[0]] * n


def _pad_layer_labels(layer: DeviceLayer, lp: int) -> DeviceLayer:
    """The layer's label dimension padded to a multiple of lp: W's columns
    (dense) or the packed rows (plabel, without parent_packed), so each lp
    shard owns a contiguous label block.  The children table is untouched: it
    names real labels only, so a padded label is never a candidate."""
    pad = -layer.nr_labels % lp
    if layer.kind == "dense":
        return DeviceLayer("dense", layer.nr_labels, layer.children, W=F.pad(layer.W, (0, pad)) if pad else layer.W)
    packed = F.pad(layer.packed, (0, 0, 0, pad)) if pad else layer.packed
    return DeviceLayer("plabel", layer.nr_labels, layer.children, packed=packed)


def _pad_layer_parents(layer: DeviceLayer, lp: int) -> DeviceLayer:
    """A plabel layer's parent_packed table (built from packed and children
    when the layer has none) padded to a multiple of lp parents.  Sharding by
    parent gives each lp shard every child of its parents, so K1 scores a beam
    parent's children from one run of rows on one device.  Padded parents are
    never in a beam."""
    pp = layer.parent_packed
    if pp is None:
        host = build_parent_packed(layer.packed.cpu().numpy(), layer.children.cpu().numpy())
        pp = torch.from_numpy(host).to(layer.device)
    pad = -pp.shape[0] % lp
    if pad:
        pp = F.pad(pp, (0, 0, 0, 0, 0, pad))
    return DeviceLayer("plabel", layer.nr_labels, layer.children, parent_packed=pp)


def _block(layer: DeviceLayer, j: int, lp: int) -> DeviceLayer:
    """Shard j of lp of a padded layer: a block of W's columns, of packed
    rows or of parent_packed parents (a view), with the whole children table."""
    if layer.W is not None:
        b = layer.W.shape[1] // lp
        return DeviceLayer("dense", b, layer.children, W=layer.W[:, j * b : (j + 1) * b])
    if layer.packed is not None:
        b = layer.packed.shape[0] // lp
        return DeviceLayer("plabel", b, layer.children, packed=layer.packed[j * b : (j + 1) * b])
    b = layer.parent_packed.shape[0] // lp
    return DeviceLayer("plabel", layer.nr_labels, layer.children, parent_packed=layer.parent_packed[j * b : (j + 1) * b])


def mesh_layers(compiled, mesh: Mesh, engine: str) -> List[List[List[DeviceLayer]]]:
    """``compiled``'s layers laid out for ``engine`` on the mesh, as
    ``[dp row][lp column][layer]`` on ``mesh.devices[row][column]``:
    ``"labels"`` pads and splits label blocks (the dense engine),
    ``"parents"`` splits plabel layers by parent block (the sparse engine),
    ``"replicated"`` copies whole layers.  Built once per (mesh devices,
    engine) and kept on the model (``compiled.mesh_layers``); each lp block is
    moved to a device once, however many rows share that device, and a block
    on the model's own device is a view of its layers."""
    key = (mesh.devices, engine)
    if key not in compiled.mesh_layers:
        lp = mesh.shape["lp"]
        if engine == "replicated":
            blocks = [compiled.layers] * lp
        else:
            pad = {
                "labels": lambda l: _pad_layer_labels(l, lp),
                "parents": lambda l: _pad_layer_labels(l, lp) if l.kind == "dense" else _pad_layer_parents(l, lp),
            }[engine]
            padded = [pad(l) for l in compiled.layers]
            blocks = [[_block(l, j, lp) for l in padded] for j in range(lp)]
        moved = {}
        for row in mesh.devices:
            for j, dev in enumerate(row):
                if (j, dev) not in moved:
                    moved[j, dev] = [b.to(dev) for b in blocks[j]]
        compiled.mesh_layers[key] = [[moved[j, dev] for j, dev in enumerate(row)] for row in mesh.devices]
    return compiled.mesh_layers[key]


def _gather_lp(raws: Sequence[torch.Tensor], owns: Sequence[torch.Tensor], home: torch.device) -> torch.Tensor:
    """The full candidate scores from the lp shards' scores of the candidates
    each owns: the others set to NEG_INF, moved to ``home`` and maxed.  Every
    valid candidate has exactly one owner, so it gets the owner's score bit
    for bit (the JAX package's ``lax.pmax`` over lp)."""
    masked = [torch.where(own, raw, NEG_INF).to(home) for raw, own in zip(raws, owns)]
    return torch.stack(masked).amax(dim=0)


def _own(cand: torch.Tensor, j: int, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(whether shard j owns each of ``cand``'s ids, the ids local to its block, clamped)."""
    local = cand - j * block
    return (local >= 0) & (local < block), local.clamp(0, block - 1)


def _check_rows(N: int, dp: int) -> int:
    if N % dp:
        raise ValueError(f"batch {N} not divisible by dp={dp}")
    return N // dp


def _beam_on_mesh(mesh: Mesh, compiled, engine: str, n_rows: int, upload, score, beam_size: int, only_topk: int, pp_names):
    """The label-sharded beam search of both engines over ``n_rows`` queries.
    Per dp row, ``upload(rows, dev)`` puts that row's queries on each of its
    devices once; per level, ``score(queries, layer, j, cand, parents, dev)``
    gives lp shard j's (scores, owned) for the expanded candidates, which are
    gathered over lp before the row's top-k.  Returns (labels, values) on the
    mesh's first device."""
    n = _check_rows(n_rows, mesh.shape["dp"])
    grid = mesh_layers(compiled, mesh, engine)
    out = []
    for i, row in enumerate(mesh.devices):
        home, shards = row[0], grid[i]
        queries = {dev: upload(slice(i * n, (i + 1) * n), dev) for dev in set(row)}
        parents, pvals = root_beam(compiled.layers[0].children.shape[0], n, pp_names[0], home)
        for d in range(compiled.depth):
            _, cand, valid = expand_beam(shards[0][d].children, parents)
            raws, owns = zip(*(score(queries[dev], shards[j][d], j, cand, parents, dev) for j, dev in enumerate(row)))
            k = only_topk if d == compiled.depth - 1 else beam_size
            parents, pvals = select_beam(
                _gather_lp(raws, owns, home), cand, valid, pvals, k, PostProcessor.get(pp_names[d]), no_prev=(d == 0)
            )
        out.append((parents, pvals))
    return _concat(mesh, out)


def _sparse_chain(mesh: Mesh, compiled, ids: np.ndarray, vals: np.ndarray, beam_size: int, only_topk: int, pp_names):
    """The sparse label-sharded beam search over padded queries; returns
    (labels, values) on the mesh's first device."""
    bias_id = compiled.nr_features if compiled.bias > 0 else None

    def score(q, local, j, cand, parents, dev):
        qids, qvals = q
        if local.kind == "dense":
            own, lc = _own(cand.to(dev), j, local.nr_labels)
            return score_candidates_dense_sparse(qids, qvals, local, lc, bias_id, compiled.bias), own
        # a beam parent this shard does not own reads row -1: K1 reads
        # nothing for it and scores 0, and it is masked by the owned mask
        Pb, maxc, twoP = local.parent_packed.shape
        own_p, lpar = _own(parents.to(dev), j, Pb)
        rows = torch.add(torch.arange(maxc, device=dev), lpar[:, :, None], alpha=maxc)
        rows = torch.where(own_p[:, :, None], rows, -1).reshape(rows.shape[0], -1)
        raw = intersect_scores_rows(qids, qvals, local.parent_packed.view(-1, twoP), rows, bias_id, compiled.bias)
        return raw, own_p.repeat_interleave(maxc, dim=1)

    upload = lambda rows, dev: (_upload(ids[rows], dev), _upload(vals[rows], dev))
    return _beam_on_mesh(mesh, compiled, "parents", ids.shape[0], upload, score, beam_size, only_topk, pp_names)


def _dense_chain(mesh: Mesh, compiled, Xd: np.ndarray, beam_size: int, only_topk: int, pp_names):
    """The dense label-sharded beam search over dense (N, D+1) queries;
    returns (labels, values) on the mesh's first device."""

    def score(q, local, j, cand, parents, dev):
        own, lc = _own(cand.to(dev), j, local.nr_labels)
        return score_candidates(q, local, lc), own

    upload = lambda rows, dev: _upload(np.ascontiguousarray(Xd[rows]), dev)
    return _beam_on_mesh(mesh, compiled, "labels", Xd.shape[0], upload, score, beam_size, only_topk, pp_names)


def _concat(mesh: Mesh, parts) -> Tuple[torch.Tensor, torch.Tensor]:
    home = mesh.devices[0][0]
    return torch.cat([l.to(home) for l, _ in parts]), torch.cat([v.to(home) for _, v in parts])


def shard_chain_predict(mesh: Mesh, compiled, X, *, beam_size: int = 10, only_topk: int = 20, post_processor="l3-hinge"):
    """Data-parallel beam search from dense queries: the model replicated on
    every device of the mesh, the queries split over all of them in order (N
    must divide by the mesh's size).  Returns (labels, values) on the mesh's
    first device."""
    Xd = prepare_queries(X, compiled.bias)
    devs = [dev for row in mesh.devices for dev in row]
    n = _check_rows(Xd.shape[0], len(devs))
    grid = [layers for row in mesh_layers(compiled, mesh, "replicated") for layers in row]
    pps = _pp_names(post_processor, compiled.depth)
    parts = [
        chain_predict(_upload(np.ascontiguousarray(Xd[s * n : (s + 1) * n]), dev), layers, beam_size, only_topk, pps)
        for s, (dev, layers) in enumerate(zip(devs, grid))
    ]
    return _concat(mesh, parts)


def shard_chain_predict_labels(mesh: Mesh, compiled, X, *, beam_size: int = 10, only_topk: int = 20, post_processor="l3-hinge"):
    """Label-sharded (model-parallel) beam search from dense queries: every
    layer's labels split over lp (W's columns, or the packed rows of plabel
    layers), queries over dp.  Each shard scores the candidates in its label
    block; per level the scores are gathered over lp and the top-k runs once
    per dp group.  N must divide by dp.  Returns (labels, values) on the
    mesh's first device."""
    return _dense_chain(mesh, compiled, prepare_queries(X, compiled.bias), beam_size, only_topk, _pp_names(post_processor, compiled.depth))


def shard_chain_predict_labels_sparse(
    mesh: Mesh, compiled, X, *, beam_size: int = 10, only_topk: int = 20, post_processor="l3-hinge"
):
    """Label-sharded beam search on the sparse query engine, the one
    ``CompiledHierModel.predict`` runs on one device: queries travel padded
    as (ids, values); dense layers' W is split by label columns and scored by
    a W-row gather; plabel layers' parent_packed is split by parent block over
    lp, and each shard scores its own beam parents' children with K1 (one
    launch per shard and level).  N must divide by dp.  Returns (labels,
    values) on the mesh's first device."""
    A = X.tocsr() if smat.issparse(X) else smat.csr_matrix(np.asarray(X, np.float32))
    ids, vals = prepare_queries_padded(A)
    return _sparse_chain(mesh, compiled, ids, vals, beam_size, only_topk, _pp_names(post_processor, compiled.depth))


def predict_sharded(
    mesh: Mesh, compiled, X, *, beam_size: int = 10, only_topk: int = 20, post_processor="l3-hinge", batch_size: int = 1024
) -> smat.csr_matrix:
    """Label-sharded predict of any X -> top-k CSR, what
    ``XLinearModel.predict(..., mesh=...)`` calls.  Sparse queries take the
    sparse engine, dense ones the dense engine; queries go in batches of
    ``batch_size`` rounded down to a multiple of dp (the last one padded up to
    one), all padded to the widest row's power-of-two cap, as
    ``CompiledHierModel.predict`` pads them."""
    if hasattr(compiled, "_get_compiled"):
        compiled = compiled._get_compiled()
    _check_features(X, compiled.nr_features)
    pp_names = _pp_names(post_processor, compiled.depth)
    dp, N, D = mesh.shape["dp"], X.shape[0], compiled.nr_features
    batch = max(dp, batch_size // dp * dp)
    up = lambda rows: -(-rows // dp) * dp
    pending = []
    if smat.issparse(X):
        A = X.tocsr()
        max_nnz = int(np.diff(A.indptr).max()) if N else 1
        cap = max(64, 1 << max(0, max_nnz - 1).bit_length())
        for s in range(0, N, batch):
            ids, vals = prepare_queries_padded(A[s : s + batch], cap=cap)
            labels, scores = _sparse_chain(mesh, compiled, *pad_query_rows(ids, vals, up(ids.shape[0]), D), beam_size, only_topk, pp_names)
            pending.append((labels[: N - s], scores[: N - s]))
    else:
        Xd = prepare_queries(X, compiled.bias)
        for s in range(0, N, batch):
            xb = Xd[s : s + batch]
            xb = np.vstack([xb, np.zeros((up(xb.shape[0]) - xb.shape[0], xb.shape[1]), np.float32)])
            labels, scores = _dense_chain(mesh, compiled, xb, beam_size, only_topk, pp_names)
            pending.append((labels[: N - s], scores[: N - s]))
    return _fetch_topk(pending, only_topk, compiled.nr_labels)


def shard_solve_block(
    mesh: Mesh,
    X,  # (N, D) float32, bias column appended; N divisible by dp
    y,  # (N, Lb) +-1; Lb divisible by lp
    c,  # (N, Lb) cost
    *,
    loss: str = "sqhinge",
    eps: float = 0.01,
    max_newton: int = 20,
    cg_max: int = 10,
) -> torch.Tensor:
    """``solvers.solve_block`` sharded over the mesh: X's rows over dp and the
    labels over lp.  Label blocks are independent problems; in each, the
    margins X W are the row shards' products concatenated and X^T G the row
    shards' products summed in shard order (XLA's psum over dp).  Returns W
    (D, Lb) on the mesh's first device."""
    dp, lp = mesh.shape["dp"], mesh.shape["lp"]
    X, y, c = (torch.as_tensor(np.asarray(a, np.float32)) for a in (X, y, c))
    N, D = X.shape
    n, b = _check_rows(N, dp), y.shape[1] // lp
    if y.shape[1] % lp:
        raise ValueError(f"{y.shape[1]} labels not divisible by lp={lp}")
    W = [
        _solve_label_block(
            [row[j] for row in mesh.devices], X, y[:, j * b : (j + 1) * b], c[:, j * b : (j + 1) * b], n,
            loss=loss, eps=eps, max_newton=max_newton, cg_max=cg_max,
        ).to(mesh.devices[0][0])
        for j in range(lp)
    ]
    return torch.cat(W, dim=1)


def _solve_label_block(col: List[torch.device], X, y, c, n: int, **solve_kw) -> torch.Tensor:
    """One label block's solve over the dp devices of its mesh column; W
    (D, b) on the column's first device."""
    home = col[0]
    Xs = [X[i * n : (i + 1) * n].to(dev) for i, dev in enumerate(col)]

    def margins(W):  # (1, D, b) -> (1, N, b)
        return torch.cat([torch.bmm(Xi[None], W.to(dev)).to(home) for Xi, dev in zip(Xs, col)], dim=1)

    def xt_apply(G):  # (1, N, b) -> (1, D, b)
        out = None
        for i, (Xi, dev) in enumerate(zip(Xs, col)):
            part = torch.bmm(Xi.T[None], G[:, i * n : (i + 1) * n].to(dev)).to(home)
            out = part if out is None else out + part
        return out

    return solvers.solve_contractions(margins, xt_apply, y.to(home)[None], c.to(home)[None], X.shape[1], **solve_kw)[0]
