"""4-bit product quantization for HNSW level-0 scoring.

The port of ``pecos_tpu/ann/hnsw/pq.py``: 16 centroids per subspace (4 bits a
code), codes kept unpacked as (N, S) uint8 on the device, a per-query (B, S, 16)
distance table (LUT), and a candidate's approximate distance
``sum_s LUT[b, s, code[n, s]]``.  Codebooks train with batched Lloyd rounds
over all subspaces at once (one ``torch.bmm`` a round).

The JAX package applies the LUT as a 4-level select tree, which suits the
TPU's vector unit; on the card a gather of the table does the same job, and
both give the same selected values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pecos_tpu_torch.utils.torch_util import DeviceLike, make_generator, resolve_device


@dataclasses.dataclass
class ProductQuantizer4Bits:
    """Codebooks (S, 16, d_sub) + per-point codes (N, S) uint8, on the host."""

    codebooks: np.ndarray  # (S, 16, d_sub) float32
    codes: np.ndarray  # (N, S) uint8
    dim: int  # original (unpadded) feature dim

    @property
    def num_subspaces(self) -> int:
        return self.codebooks.shape[0]

    @property
    def d_sub(self) -> int:
        return self.codebooks.shape[2]


def _pad_dim(X: np.ndarray, num_subspaces: int) -> np.ndarray:
    """Zero columns appended so the width splits into num_subspaces equal parts."""
    pad = -X.shape[1] % num_subspaces
    return np.hstack([X, np.zeros((X.shape[0], pad), X.dtype)]) if pad else X


def _sq_dists(Xs: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(S, n, d) x (S, 16, d) -> (S, n, 16) squared distances."""
    return (Xs * Xs).sum(-1, keepdim=True) - 2.0 * torch.bmm(Xs, cent.transpose(1, 2)) + (cent * cent).sum(-1)[:, None, :]


def _kmeans16(Xs: torch.Tensor, init_idx: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd rounds for every subspace at once: Xs (S, n, d), init_idx (S, 16)
    row indices of the starting centroids -> (S, 16, d) centroids.  A centroid
    that loses all its points keeps its place."""
    S, n, d = Xs.shape
    cent = Xs.gather(1, init_idx.long()[:, :, None].expand(S, 16, d))
    for _ in range(iters):
        assign = _sq_dists(Xs, cent).argmin(dim=-1)  # (S, n)
        sums = torch.zeros_like(cent).scatter_add_(1, assign[:, :, None].expand(S, n, d), Xs)
        cnts = torch.zeros((S, 16), device=Xs.device).scatter_add_(1, assign, torch.ones_like(Xs[:, :, 0]))
        new = sums / cnts.clamp(min=1.0)[:, :, None]
        cent = torch.where(cnts[:, :, None] > 0, new, cent)
    return cent


def _encode_chunk_device(feats: torch.Tensor, cent: torch.Tensor, s0: int, *, S: int, d_sub: int, chunk: int) -> torch.Tensor:
    """Codes of rows [s0, s0+chunk) of a device feature array: the nearest of
    16 centroids per subspace.  The start is clamped so the chunk fits, as
    ``lax.dynamic_slice`` does."""
    s0 = max(0, min(int(s0), feats.shape[0] - chunk))
    blk = feats[s0 : s0 + chunk].float()
    pad = S * d_sub - blk.shape[1]
    if pad:
        blk = torch.cat([blk, blk.new_zeros((blk.shape[0], pad))], dim=1)
    Xs = blk.reshape(-1, S, d_sub).transpose(0, 1)  # (S, chunk, d_sub)
    return _sq_dists(Xs, cent).argmin(dim=-1).T.to(torch.uint8)


def train_pq4(
    X: np.ndarray,
    num_subspaces: int = 64,
    iters: int = 10,
    seed: int = 0,
    max_train_points: int = 131072,
    feats_dev: Optional[torch.Tensor] = None,
    device: DeviceLike = "cuda",
) -> ProductQuantizer4Bits:
    """Per-subspace 16-centroid codebooks and the codes of every point.

    Codebooks train on at most ``max_train_points`` rows, drawn with numpy
    from ``seed`` as the JAX package draws them; the starting centroids come
    from a ``torch.Generator`` seeded with ``seed`` (other draws than JAX's).
    Encoding runs on the device in chunks, from ``feats_dev`` when the caller
    already holds the features there."""
    dev = resolve_device(device)
    N, D = X.shape
    Xp = _pad_dim(np.asarray(X, np.float32), num_subspaces)
    d_sub = Xp.shape[1] // num_subspaces
    if N > max_train_points:
        Xp = Xp[np.random.default_rng(seed).choice(N, max_train_points, replace=False)]
    Xs = torch.from_numpy(np.ascontiguousarray(Xp.reshape(-1, num_subspaces, d_sub).transpose(1, 0, 2))).to(dev)
    gen = make_generator(seed, dev)
    init = torch.stack([torch.randperm(Xs.shape[1], generator=gen, device=dev)[:16] for _ in range(num_subspaces)])
    cent = _kmeans16(Xs, init, iters)
    del Xs
    feats = feats_dev if feats_dev is not None else torch.from_numpy(np.asarray(X, np.float32)).to(dev)
    chunk = min(N, 1 << 17)
    codes = np.empty((N, num_subspaces), np.uint8)
    for s0 in range(0, N, chunk):
        s0 = min(s0, N - chunk)  # the last chunk re-aimed to end at N
        codes[s0 : s0 + chunk] = _encode_chunk_device(feats, cent, s0, S=num_subspaces, d_sub=d_sub, chunk=chunk).cpu().numpy()
    return ProductQuantizer4Bits(codebooks=cent.cpu().numpy(), codes=codes, dim=D)


def build_lut(pq: ProductQuantizer4Bits, Q: np.ndarray, metric: str) -> np.ndarray:
    """Per-query LUT (B, S, 16) on the host: each centroid's share of the
    distance.  l2: ||q_s - c||^2; ip: -<q_s, c> (the caller's 1 - <q, x>
    convention adds the 1)."""
    B = Q.shape[0]
    Qs = _pad_dim(np.asarray(Q, np.float32), pq.num_subspaces).reshape(B, pq.num_subspaces, pq.d_sub)
    dots = np.einsum("bsd,skd->bsk", Qs, pq.codebooks)
    if metric == "ip":
        return (-dots).astype(np.float32)
    qq = (Qs**2).sum(-1, keepdims=True)
    cc = (pq.codebooks**2).sum(-1)[None, :, :]
    return (qq + cc - 2.0 * dots).astype(np.float32)


def build_lut_device(codebooks: torch.Tensor, Q: torch.Tensor, *, metric: str) -> torch.Tensor:
    """build_lut on the device: codebooks (S, 16, d_sub), Q (B, D) -> (B, S, 16)."""
    S, _, d_sub = codebooks.shape
    B, D = Q.shape
    Qf = Q.float()
    if S * d_sub > D:
        Qf = torch.cat([Qf, Qf.new_zeros((B, S * d_sub - D))], dim=1)
    Qs = Qf.reshape(B, S, d_sub)
    dots = torch.einsum("bsd,skd->bsk", Qs, codebooks)
    if metric == "ip":
        return -dots
    return (Qs * Qs).sum(-1, keepdim=True) + (codebooks * codebooks).sum(-1)[None] - 2.0 * dots


def pq_apply_lut(lut: torch.Tensor, c: torch.Tensor, ip_offset: float = 0.0) -> torch.Tensor:
    """sum_s lut[b, s, c[b, k, s]] for gathered codes c (B, K, S) -> (B, K)."""
    B, K, S = c.shape
    idx = c.long() + torch.arange(0, 16 * S, 16, device=c.device)  # flat (s, code) index
    v = lut.reshape(B, 1, S * 16).expand(B, K, S * 16).gather(2, idx)
    return v.sum(-1) + ip_offset


def pq_gather_dist(lut: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor, ip_offset: float = 0.0) -> torch.Tensor:
    """Approximate distances of candidates ids (B, K): sum_s LUT[b, s, code[id, s]]."""
    return pq_apply_lut(lut, codes[ids.long().clamp(0, codes.shape[0] - 1)], ip_offset)
