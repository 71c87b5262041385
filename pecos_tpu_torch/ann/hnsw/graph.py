"""HNSW as padded fixed-degree tensors, searched and built batch by batch.

The port of ``pecos_tpu/ann/hnsw/graph.py``.  A level of the graph is an
(N, M) int32 adjacency, -1 padded; the features are a dense (N, D) tensor or,
for CSR corpora, :class:`SparseFeats`.  A whole query batch walks the graph in
lockstep: each step pops the ``expand`` best unexpanded beam entries of every
query, scores their neighbors with one batched gather + product (dense) or
one K1 launch (sparse), drops ids already in the beam and keeps the ef best.

Lockstep means a query's result depends on its batch: the loop runs while ANY
query of the batch is active, and the body runs on every query.  The port
runs the same number of steps as the JAX package.  It reads the loop flag on
the host once every ``CHECK_EVERY[device type]`` steps (every step on the
CPU, every 8th on a GPU); the steps in between are gated on the device
(``torch.where`` keeps the state once the flag is down), so the result does
not depend on the period.  ``read_flag.syncs`` counts the reads.

Ties follow the JAX package: ``lax.top_k`` and ``lax.sort`` keep equal keys in
index order, so every top-k and sort here is a stable ``torch.sort`` followed
by gathers; a two-key sort is a stable sort on the second key, then on the
first.  Ids travel as int64 (torch's index type); adjacencies are stored int32,
as on disk.  Distances are float32 (TF32 off); a bfloat16 feature copy is
upcast before its products, which makes them exact in float32 as JAX's
``preferred_element_type=float32`` does, while the squared norms are summed in
bfloat16 as JAX sums them.

The PQ-guided build keeps a packed neighbor-code array ``desc`` (N, cap*S)
uint8 beside level 0 (see ``pack_neighbor_codes``): the row writers
``scatter_set_rows_d``, ``reverse_merge_closest``, ``reverse_merge_chunk`` and
``scatter_prune_rows`` take an optional ``packed=(desc, codes)`` and re-pack
the rows they write, which is what the JAX package's ``*_packed`` twins do.

Not ported: ``batch_greedy_descent_stack``, which nothing calls.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as smat
import torch

from pecos_tpu_torch.ops.intersect import intersect_scores_rows, split_packed
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device

PAD = -1
INF = 3.4e38  # float32, the JAX package's INF
SPARSE_PAD_ID = 1 << 30  # sorts after every real feature id
_BIG_ID = 1 << 30  # id key of empty slots in id-ordered sorts
# search-loop steps per host read of the loop flag, by device type (see the module docstring)
CHECK_EVERY = {"cpu": 1, "cuda": 8}


def to_device(a, dtype, device: torch.device) -> torch.Tensor:
    """A host array as a tensor of numpy ``dtype`` on ``device``, copied (the
    array may be read-only, as those of an npz file or of jax are)."""
    return torch.from_numpy(np.array(a, dtype)).to(device)


@dataclasses.dataclass
class SparseBlock:
    """A batch of sparse rows: ids sorted ascending, SPARSE_PAD_ID padded;
    values 0 at the pads; squared norms.  Contiguous, as K1 takes them."""

    ids: torch.Tensor  # (B, Q) int32
    vals: torch.Tensor  # (B, Q) float32
    sq: torch.Tensor  # (B,) float32

    @property
    def shape(self):
        return self.ids.shape


@dataclasses.dataclass
class SparseFeats:
    """Every node's features in padded sparse form, each row packed as
    [ids | float bits] (K1's weight layout), so one row gather feeds K1."""

    packed: torch.Tensor  # (N, 2P) int32
    sq: torch.Tensor  # (N,) float32 squared norms

    @property
    def ids(self) -> torch.Tensor:
        return split_packed(self.packed)[0]

    @property
    def vals(self) -> torch.Tensor:
        return split_packed(self.packed)[1]

    @property
    def shape(self):
        return self.ids.shape

    def __getitem__(self, idx) -> SparseBlock:
        ids, vals = split_packed(self.packed[idx])
        return SparseBlock(ids.contiguous(), vals.contiguous(), self.sq[idx])

    @classmethod
    def from_numpy(cls, ids: np.ndarray, vals: np.ndarray, sq: np.ndarray, device: DeviceLike = "cuda") -> "SparseFeats":
        """From padded (N, P) int32 ids / float32 values and (N,) squared norms."""
        packed = np.concatenate([np.asarray(ids, np.int32), np.asarray(vals, np.float32).view(np.int32)], axis=1)
        dev = resolve_device(device)
        return cls(torch.from_numpy(packed).to(dev), to_device(sq, np.float32, dev))


def build_sparse_feats(X, round_to: int = 32, cap: int = 0, device: DeviceLike = "cuda") -> SparseFeats:
    """CSR rows -> SparseFeats on ``device``; the row capacity is the longest
    row rounded up to ``round_to``, or ``cap``."""
    A = X.tocsr() if smat.issparse(X) else smat.csr_matrix(X)
    A.sort_indices()
    nnz = np.diff(A.indptr)
    if not cap:
        longest = int(nnz.max()) if len(nnz) else 1
        cap = max(round_to, -(-longest // round_to) * round_to)
    ids = np.full((A.shape[0], cap), SPARSE_PAD_ID, np.int32)
    vals = np.zeros((A.shape[0], cap), np.float32)
    rows = np.repeat(np.arange(A.shape[0]), nnz)
    offs = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz)
    ids[rows, offs] = A.indices
    vals[rows, offs] = A.data
    sq = np.asarray(A.multiply(A).sum(axis=1), np.float32).ravel()
    return SparseFeats.from_numpy(ids, vals, sq, device)


Feats = Union[torch.Tensor, SparseFeats]
Queries = Union[torch.Tensor, SparseBlock]


@dataclasses.dataclass
class DeviceGraph:
    """One level of the graph and the features it links, on one device."""

    feats: Feats  # (N, D) float32 / bfloat16, or SparseFeats
    neighbors: torch.Tensor  # (N, M) int32, -1 padded
    metric: str  # "l2" | "ip"

    @classmethod
    def from_numpy(cls, feats, neighbors: np.ndarray, metric: str, device: DeviceLike = "cuda") -> "DeviceGraph":
        """From host arrays (dense features or CSR), e.g. a graph the JAX package built."""
        dev = resolve_device(device)
        if smat.issparse(feats):
            f = build_sparse_feats(feats, device=dev)
        else:
            f = to_device(feats, np.float32, dev)
        return cls(f, to_device(neighbors, np.int32, dev), metric)


def pairwise_dist(Q: torch.Tensor, X: torch.Tensor, metric: str) -> torch.Tensor:
    """(B, D) x (K, D) -> (B, K) distances, smaller is closer: l2 -> squared
    L2, ip -> 1 - <q, x> (the reference's inner-product "distance")."""
    dots = Q.float() @ X.float().T
    if metric == "ip":
        return 1.0 - dots
    return (Q * Q).sum(1, keepdim=True) + (X * X).sum(1)[None, :] - 2.0 * dots


def _sparse_gather_dots(Q: SparseBlock, feats: SparseFeats, ids: torch.Tensor) -> torch.Tensor:
    """<q_b, x_{ids[b,k]}> for sparse q and x: (B, K) float32 through K1
    (the CUDA kernel on a GPU, its plain version on the CPU), which reads the
    rows of ``feats.packed`` by id.  The pads are SPARSE_PAD_ID on both sides
    with value 0, so pad matches add nothing."""
    return intersect_scores_rows(Q.ids, Q.vals, feats.packed, ids.clamp(0, feats.packed.shape[0] - 1))


def gather_dist(Q: Queries, feats: Feats, ids: torch.Tensor, metric: str) -> torch.Tensor:
    """Per-query distances to gathered nodes: ids (B, K) -> (B, K) float32."""
    safe = ids.clamp(0, feats.shape[0] - 1)
    if isinstance(feats, SparseFeats):
        dots = _sparse_gather_dots(Q, feats, safe)
        if metric == "ip":
            return 1.0 - dots
        return Q.sq[:, None] + feats.sq[safe] - 2.0 * dots
    F = feats[safe]  # (B, K, D)
    dots = torch.bmm(F.float(), Q.float()[:, :, None])[:, :, 0]
    if metric == "ip":
        return 1.0 - dots
    # a bfloat16 copy sums its squares in bfloat16, as the JAX package does
    return (Q * Q).sum(1, keepdim=True) + (F * F).sum(-1) - 2.0 * dots


def read_flag(flag: torch.Tensor) -> bool:
    """A loop flag read on the host: the searches' one sync.
    ``read_flag.syncs`` counts the reads."""
    read_flag.syncs += 1
    return bool(flag)


read_flag.syncs = 0


def _while_loop(cond: Callable, body: Callable, state: tuple, max_steps: int) -> tuple:
    """``lax.while_loop(steps < max_steps and cond, body)`` in eager torch:
    the flag is read on the host every ``CHECK_EVERY`` steps and the steps in
    between only change the state while it is up."""
    every = CHECK_EVERY[state[0].device.type]
    for step in range(max_steps):
        go = cond(state)
        if step % every == 0:
            if not read_flag(go):
                break
            state = body(state)
        else:
            state = tuple(torch.where(go, new, old) for new, old in zip(body(state), state))
    return state


def _sort_take(keys: torch.Tensor, *others: torch.Tensor, k: int = None):
    """Stable ascending sort of ``keys`` along dim 1 (``lax.sort`` with one
    key), the first ``k`` columns, and ``others`` gathered in that order."""
    sk, order = torch.sort(keys, dim=1, stable=True)
    if k is not None:
        sk, order = sk[:, :k], order[:, :k]
    return (sk, *(o.gather(1, order) for o in others))


def _sort2(key1: torch.Tensor, key2: torch.Tensor) -> torch.Tensor:
    """The order of a stable sort along the last dim by (key1, key2): a
    stable sort on key2, then on key1 (``lax.sort`` with ``num_keys=2``)."""
    o2 = torch.sort(key2, dim=-1, stable=True)[1]
    o1 = torch.sort(key1.gather(-1, o2), dim=-1, stable=True)[1]
    return o2.gather(-1, o1)


def _after_repeat(x: torch.Tensor) -> torch.Tensor:
    """(B, K) bool: True where an entry equals the one before it in its row."""
    return torch.cat([torch.zeros_like(x[:, :1], dtype=torch.bool), x[:, 1:] == x[:, :-1]], dim=1)


def _beam_search(
    entry_ids: torch.Tensor,  # (B, E) int64 starting points (-1 padded)
    entry_dists: torch.Tensor,  # (B, E)
    neighbor_fn: Callable,  # (B, expand) popped ids -> ((B, expand*M) nbr ids, dists)
    *,
    ef: int,
    max_steps: int,
    expand: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-first beam search shared by the exact and PQ scorings.  Each step
    pops the ``expand`` best unexpanded candidates of every query; the loop
    stops when no query has an unexpanded candidate no worse than its worst
    beam entry.  Returns (ids int64 (B, ef), dists (B, ef)), ascending."""
    B, E = entry_ids.shape
    dev = entry_ids.device
    d0 = torch.where(entry_ids >= 0, entry_dists, INF)
    ids0 = torch.where(entry_ids >= 0, entry_ids.long(), PAD)
    if E < ef:
        ids0 = torch.cat([ids0, torch.full((B, ef - E), PAD, dtype=torch.long, device=dev)], dim=1)
        d0 = torch.cat([d0, torch.full((B, ef - E), INF, device=dev)], dim=1)
    d0, ids0 = _sort_take(d0, ids0, k=ef)

    def cond(state):
        ids, dists, expanded = state
        best_unexp = torch.where(expanded, INF, dists).min(dim=1).values
        worst = torch.where(ids >= 0, dists, -INF).max(dim=1).values
        return (best_unexp <= worst).any()

    def body(state):
        ids, dists, expanded = state
        top, pos = torch.sort(torch.where(expanded, INF, dists), dim=1, stable=True)
        top, pos = top[:, :expand], pos[:, :expand]  # lax.top_k: ties to the lower index
        has_cand = top < INF * 0.5
        cand_id = ids.gather(1, pos)
        expanded = expanded.scatter(1, pos, True)
        nbrs, nd = neighbor_fn(cand_id)
        nbrs = torch.where(has_cand.repeat_interleave(nbrs.shape[1] // expand, dim=1), nbrs, PAD)
        nd = torch.where(nbrs >= 0, nd, INF)
        dup = (nbrs[:, :, None] == ids[:, None, :]).any(dim=2)  # already in the beam
        nd = torch.where(dup, INF, nd)
        nbrs = torch.where(dup, PAD, nbrs)
        sd, si, se = _sort_take(
            torch.cat([dists, nd], dim=1), torch.cat([ids, nbrs], dim=1),
            torch.cat([expanded, nbrs < 0], dim=1), k=ef,
        )
        # a node popped from two parents in one step enters twice with one
        # distance, so its copies sort next to each other: drop the second
        dup2 = _after_repeat(si) & (si >= 0)
        return torch.where(dup2, PAD, si), torch.where(dup2, INF, sd), se | dup2

    ids, dists, _ = _while_loop(cond, body, (ids0, d0, ids0 < 0), max_steps)
    # exact dedup: order by id, drop repeats, restore distance order
    oid, k_d = _sort_take(torch.where(ids < 0, _BIG_ID, ids), dists)
    dupf = _after_repeat(oid) & (oid < _BIG_ID)
    d2, id2 = _sort_take(torch.where(dupf, INF, k_d), torch.where(dupf, _BIG_ID, oid))
    return torch.where(id2 >= _BIG_ID, PAD, id2), d2


def batch_search_level(
    graph: DeviceGraph,
    Q: Queries,  # (B, D) | SparseBlock
    entry_ids: torch.Tensor,  # (B, E) starting points (-1 padded)
    *,
    ef: int,
    max_steps: int,
    expand: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-distance beam search over one level of the graph."""
    B = Q.shape[0]
    N = graph.neighbors.shape[0]

    def neighbor_fn(cand_id):
        nbrs = graph.neighbors[cand_id.clamp(0, N - 1)].reshape(B, -1).long()
        return nbrs, gather_dist(Q, graph.feats, nbrs, graph.metric)

    entry_ids = entry_ids.long()
    d0 = gather_dist(Q, graph.feats, entry_ids, graph.metric)
    return _beam_search(entry_ids, d0, neighbor_fn, ef=ef, max_steps=max_steps, expand=expand)


def batch_search_level_pq(
    codes: torch.Tensor,  # (N, S) uint8 PQ codes
    neighbors: torch.Tensor,  # (N, M) int32
    lut: torch.Tensor,  # (B, S, 16) float32 per-query LUT
    entry_ids: torch.Tensor,  # (B, E)
    *,
    ef: int,
    max_steps: int,
    expand: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search scored by the per-query PQ LUT instead of exact dots."""
    from .pq import pq_gather_dist

    B = entry_ids.shape[0]
    N = neighbors.shape[0]

    def neighbor_fn(cand_id):
        nbrs = neighbors[cand_id.clamp(0, N - 1)].reshape(B, -1).long()
        return nbrs, pq_gather_dist(lut, codes, nbrs)

    entry_ids = entry_ids.long()
    d0 = pq_gather_dist(lut, codes, entry_ids)
    return _beam_search(entry_ids, d0, neighbor_fn, ef=ef, max_steps=max_steps, expand=expand)


def pack_neighbor_codes(neighbors: torch.Tensor, codes: torch.Tensor, chunk: int = 1 << 16) -> torch.Tensor:
    """(n, M) x (N, S) -> (n, M*S) uint8: each row's neighbors' PQ codes
    beside its adjacency row, so one row gather scores all M neighbors.  -1
    slots hold node 0's codes; users mask them by the id's sign.  Built in
    row chunks so no (n, M, S) int64 index exists at once."""
    n, M = neighbors.shape
    N, S = codes.shape
    out = torch.empty((n, M * S), dtype=torch.uint8, device=neighbors.device)
    for s in range(0, n, chunk):
        nb = neighbors[s : s + chunk].long().clamp(0, N - 1)
        out[s : s + chunk] = codes[nb].reshape(nb.shape[0], M * S)
    return out


def batch_search_level_pq_packed(
    codes: torch.Tensor,  # (N, S) uint8 (entry-point scoring only)
    neighbors: torch.Tensor,  # (N, M) int32
    nbr_codes: torch.Tensor,  # (N, M*S) uint8 from pack_neighbor_codes
    lut: torch.Tensor,  # (B, S, 16) float32
    entry_ids: torch.Tensor,  # (B, E)
    *,
    ef: int,
    max_steps: int,
    expand: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ search on packed neighbor codes: one row gather per popped node
    serves all its neighbors.  Same results as batch_search_level_pq."""
    from .pq import pq_apply_lut, pq_gather_dist

    B = entry_ids.shape[0]
    N, M = neighbors.shape
    S = nbr_codes.shape[1] // M

    def neighbor_fn(cand_id):
        safe = cand_id.clamp(0, N - 1)
        nbrs = neighbors[safe].reshape(B, -1).long()
        return nbrs, pq_apply_lut(lut, nbr_codes[safe].reshape(B, -1, S))

    entry_ids = entry_ids.long()
    d0 = pq_gather_dist(lut, codes, entry_ids)
    return _beam_search(entry_ids, d0, neighbor_fn, ef=ef, max_steps=max_steps, expand=expand)


def _greedy_level(feats: Feats, neighbors: torch.Tensor, Q: Queries, entry: torch.Tensor, metric: str, max_steps: int) -> torch.Tensor:
    """Greedy walk on one level: every query moves to its closest neighbor
    while that improves on where it stands.  Returns (B,) int64 node ids."""
    N = neighbors.shape[0]
    cur = entry.long()
    cur_d = gather_dist(Q, feats, cur[:, None], metric)[:, 0]

    def cond(state):
        return state[2].any()

    def body(state):
        cur, cur_d, improved = state
        nbrs = neighbors[cur.clamp(0, N - 1)].long()  # (B, M)
        nd = torch.where(nbrs >= 0, gather_dist(Q, feats, nbrs, metric), INF)
        best = nd.argmin(dim=1, keepdim=True)  # the first of equal minima, as jnp.argmin
        best_d, best_id = nd.gather(1, best)[:, 0], nbrs.gather(1, best)[:, 0]
        take = improved & (best_d < cur_d)
        return torch.where(take, best_id, cur), torch.where(take, best_d, cur_d), take

    return _while_loop(cond, body, (cur, cur_d, torch.ones_like(cur, dtype=torch.bool)), max_steps)[0]


def batch_greedy_descent(graph: DeviceGraph, Q: Queries, entry: torch.Tensor, *, max_steps: int) -> torch.Tensor:
    """Greedy walk to the locally closest node of one upper level."""
    return _greedy_level(graph.feats, graph.neighbors, Q, entry, graph.metric, max_steps)


def batch_greedy_descent_multi(
    feats: Feats,
    uppers: Sequence[torch.Tensor],  # (N, maxM) adjacencies, TOP level first
    Q: Queries,
    entry: torch.Tensor,  # (B,)
    *,
    metric: str,
    max_steps: int,
) -> torch.Tensor:
    """Greedy descent through several upper levels, top level first."""
    cur = entry
    for neighbors in uppers:
        cur = _greedy_level(feats, neighbors, Q, cur, metric, max_steps)
    return cur


def _compact_selected(sel_mask: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor, M: int):
    """Selected ids and distances moved left in candidate order, -1 / INF padded, M wide."""
    E = ids.shape[1]
    col = torch.arange(E, device=ids.device)[None, :]
    _, picked, picked_d = _sort_take(
        torch.where(sel_mask, col, E), torch.where(sel_mask, ids, PAD), torch.where(sel_mask, dists, INF), k=M,
    )
    return picked, picked_d


def batch_select_neighbors(
    cand_ids: torch.Tensor,  # (B, E) sorted by distance ascending (-1 padded)
    cand_dists: torch.Tensor,  # (B, E)
    cross: torch.Tensor,  # (B, E, E) distances among the candidates
    *,
    M: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HNSW Alg. 4 for a batch in lockstep: step i keeps candidate i of every
    query when it is closer to the query than to every neighbor kept so far,
    up to M.  Returns (ids (B, min(M, E)) -1 padded, their distances)."""
    B, E = cand_ids.shape
    sel_mask = torch.zeros((B, E), dtype=torch.bool, device=cand_ids.device)
    count = torch.zeros((B,), dtype=torch.long, device=cand_ids.device)
    for i in range(E):
        min_sel = torch.where(sel_mask, cross[:, i, :], INF).min(dim=1).values
        di = cand_dists[:, i]
        ok = (cand_ids[:, i] >= 0) & (di < INF * 0.5) & (min_sel >= di) & (count < M)
        sel_mask[:, i] = ok
        count += ok
    return _compact_selected(sel_mask, cand_ids, cand_dists, M)


def _select_sparse_lazy(
    feats: SparseFeats,
    ids: torch.Tensor,  # (B, E) sorted by distance ascending, -1 padded
    dists: torch.Tensor,  # (B, E)
    *,
    M: int,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg-4 selection for sparse features with the candidate-candidate
    distances computed on demand: step i scores candidate i against the <= M
    rows selected so far with one K1 launch (query = candidate i's row,
    weights = the selected rows of ``feats.packed`` read by id, -1 for the
    empty slots, which score 0), E*M work instead of the E^2 cross matrix.
    Same selection as batch_select_neighbors on the full cross matrix."""
    B, E = ids.shape
    N, P = feats.shape
    dev = ids.device
    safe = ids.clamp(0, N - 1)
    rows = feats.packed[safe]  # (B, E, 2P)
    csq = feats.sq[safe]  # (B, E)
    sel_rows = torch.full((B, M), -1, dtype=torch.int64, device=dev)
    buf_sq = torch.zeros((B, M), device=dev)
    slot = torch.arange(M, device=dev)[None, :]
    count = torch.zeros((B,), dtype=torch.long, device=dev)
    sel_mask = torch.zeros((B, E), dtype=torch.bool, device=dev)
    for i in range(E):
        ci, cv = split_packed(rows[:, i])
        dots = intersect_scores_rows(ci.contiguous(), cv.contiguous(), feats.packed, sel_rows)  # (B, M)
        ci_sq = csq[:, i]
        cross = 1.0 - dots if metric == "ip" else buf_sq + ci_sq[:, None] - 2.0 * dots
        min_sel = torch.where(slot < count[:, None], cross, INF).min(dim=1).values
        di = dists[:, i]
        ok = (ids[:, i] >= 0) & (di < INF * 0.5) & (min_sel >= di) & (count < M)
        put = (slot == count[:, None]) & ok[:, None]  # (B, M): the next free slot
        sel_rows = torch.where(put, safe[:, i, None], sel_rows)
        if metric != "ip":
            buf_sq = torch.where(put, ci_sq[:, None], buf_sq)
        sel_mask[:, i] = ok
        count += ok
    return _compact_selected(sel_mask, ids, dists, M)


def batch_select_from_search(
    feats: Feats,
    ids: torch.Tensor,  # (B, E) search results sorted by distance ascending
    dists: torch.Tensor,  # (B, E)
    *,
    M: int,
    metric: str,
    sketch: torch.Tensor = None,  # (N, sk) dense sketch of sparse rows for cross-distances
    pool: int = 0,  # > 0: select among the pool closest candidates only
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-distances among the candidates, then Alg-4 selection.

    Dense features: one batched product of the gathered rows.  Sparse: the
    lazy K1 selection, or with ``sketch`` the product of the count-sketch rows
    (the candidate-query distances stay exact either way).  ``pool`` cuts the
    candidate list before the quadratic cross-distance work."""
    if pool and pool < ids.shape[1]:
        ids, dists = ids[:, :pool], dists[:, :pool]
    if isinstance(feats, SparseFeats):
        if sketch is None:
            return _select_sparse_lazy(feats, ids, dists, M=M, metric=metric)
        cross = _dense_cross(sketch[ids.clamp(0, sketch.shape[0] - 1)], metric)
    else:
        cross = _dense_cross(feats[ids.clamp(0, feats.shape[0] - 1)], metric)
    return batch_select_neighbors(ids, dists, cross, M=M)


def _dense_cross(F: torch.Tensor, metric: str) -> torch.Tensor:
    """Distances among gathered dense rows: F (B, E, D) -> (B, E, E), the
    products in float32 (a bfloat16 copy is upcast first)."""
    Ff = F.float()
    dots = torch.bmm(Ff, Ff.transpose(1, 2))
    if metric == "ip":
        return 1.0 - dots
    nn = (F * F).sum(-1)
    return nn[:, :, None] + nn[:, None, :] - 2.0 * dots


def refine_union_candidates(
    neighbors: torch.Tensor,  # (N, cap)
    nbr_dists: torch.Tensor,  # (N, cap) distance co-array
    nodes: torch.Tensor,  # (B,) node ids being refined; pad with -2
    ids: torch.Tensor,  # (B, E) refine-search results
    dists: torch.Tensor,  # (B, E)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A refine search's results united with the node's current neighbors
    (their distances from the co-array), the node itself dropped, sorted
    ascending by distance."""
    N = neighbors.shape[0]
    nodes, ids = nodes.long(), ids.long()
    self_mask = ids == nodes[:, None]
    ids = torch.where(self_mask, PAD, ids)
    dists = torch.where(self_mask, INF, dists)
    safe = nodes.clamp(0, N - 1)
    ex, ex_d = neighbors[safe].long(), nbr_dists[safe]
    dup = (ex[:, :, None] == ids[:, None, :]).any(dim=2)
    ex_d = torch.where(dup | (nodes[:, None] < 0) | (ex < 0), INF, ex_d)
    ex = torch.where(dup, PAD, ex)
    all_d, all_ids = _sort_take(torch.cat([dists, ex_d], dim=1), torch.cat([ids, ex], dim=1))
    return all_ids, all_d


Packed = Optional[Tuple[torch.Tensor, torch.Tensor]]  # (desc (N, cap*S) uint8, codes (N, S) uint8)


def _set_rows_(rows: torch.Tensor, *pairs: Tuple[torch.Tensor, torch.Tensor], packed: Packed = None) -> None:
    """arr[rows] = vals in place for every (arr, vals) pair; rows outside arr
    (the >= N pads of a batch) are dropped, as JAX's ``mode="drop"``.  With
    ``packed``, the desc rows are re-packed from the first pair's new ids."""
    N = pairs[0][0].shape[0]
    keep = (rows >= 0) & (rows < N)
    r = rows[keep].long()
    arrs, vals = [a for a, _ in pairs], [v[keep] for _, v in pairs]
    if packed is not None:
        desc, codes = packed
        arrs.append(desc)
        vals.append(pack_neighbor_codes(vals[0], codes))
    for arr, v in zip(arrs, vals):
        arr.index_copy_(0, r, v.to(arr.dtype))


def _pad_cols(x: torch.Tensor, width: int, value) -> torch.Tensor:
    if x.shape[1] >= width:
        return x
    return torch.cat([x, torch.full((x.shape[0], width - x.shape[1]), value, dtype=x.dtype, device=x.device)], dim=1)


def scatter_set_rows(neighbors: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, *, packed: Packed = None) -> torch.Tensor:
    """Replace whole rows of an adjacency in place (pads >= N dropped), and
    with ``packed`` their desc rows.  Returns neighbors."""
    _set_rows_(rows, (neighbors, vals), packed=packed)
    return neighbors


def scatter_set_rows_d(
    neighbors: torch.Tensor,  # (N, cap) int32 adjacency
    nbr_dists: torch.Tensor,  # (N, cap) float32 distance co-array
    rows: torch.Tensor,  # (B,) row ids; pads >= N are dropped
    ids: torch.Tensor,  # (B, M) new neighbor ids, -1 padded, M <= cap
    d: torch.Tensor,  # (B, M) their distances to the row's node
    *,
    packed: Packed = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace whole rows of the adjacency and its distance co-array, in
    place (JAX donates the arrays; here they are updated), and with
    ``packed`` their desc rows.  Returns (neighbors, nbr_dists)."""
    cap = neighbors.shape[1]
    _set_rows_(rows, (neighbors, _pad_cols(ids, cap, PAD)), (nbr_dists, _pad_cols(d, cap, INF)), packed=packed)
    return neighbors, nbr_dists


def _reverse_merge_core(neighbors, nbr_dists, src_ids, sel_ids, sel_dists):
    """Rows and their merged neighbor lists after adding every reverse edge
    dst -> src of the forward selections src -> dst, at the same distance.

    Edges are grouped by dst, closest first, and at most cap arrive per dst
    (an arrival ranked below cap others cannot survive a keep-closest prune
    to cap).  Each dst row is then united with its arrivals, an id seen twice
    keeps its smaller distance, and the cap closest stay.  Returns (rows (E,),
    ids (E, cap), dists (E, cap)); rows past the distinct dsts are N."""
    N, cap = neighbors.shape
    B, M = sel_ids.shape
    E = B * M
    dev = sel_ids.device
    dst = sel_ids.reshape(E).long()
    src = src_ids.long()[:, None].expand(B, M).reshape(E)
    d = sel_dists.reshape(E)
    invalid = (dst < 0) | (src >= N) | (src < 0)
    dst_k = torch.where(invalid, N, dst)
    d_k = torch.where(invalid, INF, d)
    order = _sort2(dst_k, d_k)  # by dst, closest first; invalid edges all in the dst=N run
    dst_s, d_s, src_s = dst_k[order], d_k[order], src[order]
    idx = torch.arange(E, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), dst_s[1:] != dst_s[:-1]])
    rank = idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    row_slot = torch.cumsum(is_start.long(), dim=0) - 1
    # tables with one spare row E that takes every write to be dropped
    rows = torch.full((E + 1,), N, dtype=torch.long, device=dev)
    rows.scatter_(0, torch.where(is_start, row_slot, E), dst_s)
    rows = rows[:E]
    keep = rank < cap
    at = (torch.where(keep, row_slot, E), torch.where(keep, rank, 0))
    arr_src = torch.full((E + 1, cap), PAD, dtype=torch.long, device=dev).index_put_(at, src_s)[:E]
    arr_d = torch.full((E + 1, cap), INF, device=dev).index_put_(at, d_s)[:E]
    safe_rows = rows.clamp(0, N - 1)
    all_ids = torch.cat([neighbors[safe_rows].long(), arr_src], dim=1)  # (E, 2cap)
    all_d = torch.cat([nbr_dists[safe_rows], arr_d], dim=1)
    # an id twice keeps its smaller distance: order by (id, d), drop repeats
    id_key = torch.where(all_ids < 0, _BIG_ID, all_ids)
    o = _sort2(id_key, all_d)
    id_s2, d_s2 = id_key.gather(1, o), all_d.gather(1, o)
    dup = _after_repeat(id_s2) & (id_s2 < _BIG_ID)
    d_m = torch.where(dup | (id_s2 >= _BIG_ID), INF, d_s2)
    merged_d, merged_id = _sort_take(d_m, torch.where(dup, _BIG_ID, id_s2), k=cap)
    return rows, torch.where(merged_d < INF * 0.5, merged_id, PAD), merged_d


def reverse_merge_closest(
    neighbors: torch.Tensor,  # (N, cap)
    nbr_dists: torch.Tensor,  # (N, cap)
    src_ids: torch.Tensor,  # (B,) inserted node ids; pads >= N
    sel_ids: torch.Tensor,  # (B, M) forward selections, -1 padded
    sel_dists: torch.Tensor,  # (B, M)
    *,
    packed: Packed = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the reverse edges of one batch's selections into the adjacency,
    keep-closest, in place (and the desc rows with ``packed``).  Returns
    (neighbors, nbr_dists)."""
    rows, ids, d = _reverse_merge_core(neighbors, nbr_dists, src_ids, sel_ids, sel_dists)
    _set_rows_(rows, (neighbors, ids), (nbr_dists, d), packed=packed)
    return neighbors, nbr_dists


def reverse_merge_chunk(
    neighbors: torch.Tensor,
    nbr_dists: torch.Tensor,
    new_ids: torch.Tensor,  # (N_CEIL, M) forward-edge table of the refine pass
    new_d: torch.Tensor,  # (N_CEIL, M)
    s0: int,  # chunk offset
    *,
    B: int,
    packed: Packed = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """reverse_merge_closest for the forward edges of rows [s0, s0+B).  As
    in the JAX package, a start past N_CEIL - B clamps the slice (as
    ``lax.dynamic_slice`` does) but not the source ids s0 + arange(B)."""
    src = torch.arange(int(s0), int(s0) + B, device=new_ids.device)
    at = max(0, min(int(s0), new_ids.shape[0] - B))
    return reverse_merge_closest(neighbors, nbr_dists, src, new_ids[at : at + B], new_d[at : at + B], packed=packed)


def _dedup_first(cand: torch.Tensor) -> torch.Tensor:
    """cand (A, E) with every repeat of an id after its first place set to -1."""
    srt, first = torch.sort(torch.where(cand < 0, _BIG_ID, cand), dim=1, stable=True)
    dup = torch.zeros_like(cand, dtype=torch.bool).scatter_(1, first, _after_repeat(srt) & (srt < _BIG_ID))
    return torch.where(dup, PAD, cand)


def scatter_prune_rows(
    neighbors: torch.Tensor,  # (N, cap) int32 adjacency, -1 padded
    feats: Feats,
    rows: torch.Tensor,  # (A,) affected rows; pads N are dropped
    new_cands: torch.Tensor,  # (A, K) new candidate ids, -1 padded
    *,
    metric: str,
    alg4: bool = False,
    packed: Packed = None,
) -> torch.Tensor:
    """Merge new candidates into each affected row and prune it to cap, in
    place: the host-grouped reverse-edge update (the JAX package's
    ``scatter_prune_rows``, ``scatter_prune_rows_alg4`` and, with ``packed``,
    ``scatter_prune_rows_packed``).  A row's existing neighbors come before
    its arrivals, so a repeated id keeps its first place; the distances to
    the row's node come from one gather (K1 for sparse features).
    Keep-closest keeps the cap closest, ties to the lower place; ``alg4``
    sorts by distance and runs Alg. 4: over the full cross matrix for dense
    features, through the lazy K1 selection for sparse ones (the same
    selection, E*cap work instead of E^2).  Returns neighbors."""
    N, cap = neighbors.shape
    safe_rows = rows.long().clamp(0, N - 1)
    cand = _dedup_first(torch.cat([neighbors[safe_rows].long(), new_cands.long()], dim=1))  # (A, cap+K)
    d = torch.where(cand >= 0, gather_dist(feats[safe_rows], feats, cand, metric), INF)
    if alg4:
        d, cand = _sort_take(d, cand)
        if isinstance(feats, SparseFeats):
            pruned, _ = _select_sparse_lazy(feats, cand, d, M=cap, metric=metric)
        else:
            pruned, _ = batch_select_neighbors(cand, d, _dense_cross(feats[cand.clamp(0, N - 1)], metric), M=cap)
    else:
        top, pruned = _sort_take(d, cand, k=cap)
        pruned = torch.where(top < INF * 0.5, pruned, PAD)
    _set_rows_(rows, (neighbors, pruned), packed=packed)
    return neighbors


def exact_rescore(
    Q: Queries,
    feats: Feats,
    ids: torch.Tensor,  # (B, E) candidate ids (-1 padded), any order
    *,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates re-ranked by exact distance: (ids, dists) ascending, -1/INF padded."""
    ids = ids.long()
    d = torch.where(ids >= 0, gather_dist(Q, feats, ids, metric), INF)
    sd, si = _sort_take(d, torch.where(ids < 0, _BIG_ID, ids))
    return torch.where(si >= _BIG_ID, PAD, si), sd
