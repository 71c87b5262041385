"""Batched primal Newton-CG solvers for per-label binary problems, in PyTorch.

The port of ``pecos_tpu/xmc/solvers.py``.  A block of labels is solved
jointly on the convex primal objective

    f(w_l) = 0.5 ||w_l||^2 + sum_i c_il * xi(y_il x_i . w_l)

with xi the squared hinge (SVC), the log-loss (LR) or a smoothed L1 hinge, and
c_il the per-pair cost (Cp/Cn x relevance, 0 where the pair is inactive).
Labels are independent, so the joint Newton-CG is per-label Newton-CG whose
Hessian products are matrix products over the whole block.

One driver, :func:`_newton_cg`, serves every layout.  It works on a leading
batch axis B (1 for one block, the clusters of a bucket otherwise) and takes
the two X contractions as functions, so the dense layouts run ``torch.bmm``
and the chunked sparse-rows layout runs gathers and sums in a fixed order.  Every
matrix product is float32; ``torch.backends.cuda.matmul.allow_tf32`` must
stay False (its default) for the products to match the JAX package's
``preferred_element_type=float32``.

Where the JAX package loops with ``lax.while_loop`` until every label has
converged, the port reads that condition on the host once per Newton
iteration (:func:`all_converged`, which counts the reads).  A label that has
converged takes step 0, so running on would leave W unchanged; the read only
saves the remaining iterations.  CG keeps its fixed ``cg_max`` iterations,
as ``lax.fori_loop`` did, with no read.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from pecos_tpu_torch.utils.torch_util import run_sums

SOLVER_SQHINGE = "L2R_L2LOSS_SVC_PRIMAL"
SOLVER_SQHINGE_DUAL = "L2R_L2LOSS_SVC_DUAL"  # same objective, solved in the primal
SOLVER_LR = "L2R_LR_DUAL"
SOLVER_LR_PRIMAL = "L2R_LR_PRIMAL"

_LS_STEPS = 8  # backtracking halvings evaluated per line search, all at once
# solve_sparse_rows densifies X to (P, Db+1) when P*(Db+2) is at most this
# many elements (1 GB of float32); above it the chunked gather/scatter layout
# keeps memory bounded
_GLOBAL_DENSE_BUDGET = 1 << 28
# the chunked layout materialises (rows, xcap, ns) blocks of at most this many elements
_SCATTER_CHUNK_ELEMENTS = 1 << 26

# smoothed L1 hinge: quadratic on [1-gamma, 1], linear below.  Newton needs a
# twice-differentiable objective; the continuation warm-starts each sharper
# stage from the last (Newton on the 1/gamma-stiff Hessian diverges cold)
_L1_SMOOTH_GAMMA = 0.01
_L1_GAMMA_STAGES = (0.2, 0.05, 0.01)

Contraction = Callable[[torch.Tensor], torch.Tensor]


def _xi(loss: str, ym: torch.Tensor, gamma: float = _L1_SMOOTH_GAMMA) -> torch.Tensor:
    """Per-pair loss as a function of the margin z = y*m."""
    if loss == "sqhinge":
        return torch.clamp(1.0 - ym, min=0.0) ** 2
    if loss == "logistic":
        return torch.log1p(torch.exp(-ym.abs())) + torch.clamp(-ym, min=0.0)
    if loss == "l1hinge":
        quad = (1.0 - ym) ** 2 / (2.0 * gamma)
        return torch.where(ym >= 1.0, 0.0, torch.where(ym >= 1.0 - gamma, quad, 1.0 - ym - gamma / 2.0))
    raise ValueError(loss)


def _dxi(loss: str, y: torch.Tensor, ym: torch.Tensor, gamma: float = _L1_SMOOTH_GAMMA) -> torch.Tensor:
    """d xi / d m, the y chain factor included."""
    if loss == "sqhinge":
        return -2.0 * y * torch.clamp(1.0 - ym, min=0.0)
    if loss == "logistic":
        return -y * torch.sigmoid(-ym)
    if loss == "l1hinge":
        return y * torch.where(ym >= 1.0, 0.0, torch.where(ym >= 1.0 - gamma, -(1.0 - ym) / gamma, -1.0))
    raise ValueError(loss)


def _hess_w(loss: str, c: torch.Tensor, ym: torch.Tensor, gamma: float = _L1_SMOOTH_GAMMA) -> torch.Tensor:
    """Diagonal curvature weights d^2 xi / d m^2, times the cost c."""
    if loss == "sqhinge":
        return 2.0 * c * (ym < 1.0).float()
    if loss == "logistic":
        s = torch.sigmoid(ym)
        return c * s * (1.0 - s)
    if loss == "l1hinge":
        return c * ((ym >= 1.0 - gamma) & (ym < 1.0)).float() / gamma
    raise ValueError(loss)


def all_converged(done: torch.Tensor) -> bool:
    """Whether every label of the solve has converged: the solvers' one host
    sync per Newton iteration.  ``all_converged.syncs`` counts the calls."""
    all_converged.syncs += 1
    return bool(done.all())


all_converged.syncs = 0


def _newton_cg(
    margins: Contraction,  # W (B, F, ns) -> X W (B, N, ns)
    xt_apply: Contraction,  # G (B, N, ns) -> X^T G (B, F, ns)
    y: torch.Tensor,  # (B, N, ns) +-1
    c: torch.Tensor,  # (B, N, ns) cost, 0 where inactive
    F: int,
    *,
    loss: str,
    eps: float,
    max_newton: int,
    cg_max: int,
    gammas: Sequence[float] = (_L1_SMOOTH_GAMMA,),
) -> torch.Tensor:
    """Newton-CG with an 8-step vectorised Armijo line search from W = 0,
    one phase per gamma (each warm-started from the last); returns W (B, F, ns).

    A phase stops after ``max_newton`` iterations or once every label's
    gradient norm has fallen to ``eps`` times its norm at the phase's start;
    the iteration on which a label's criterion fires still takes its step,
    and every later one gives it step 0."""
    B, N, ns = y.shape
    dev = y.device
    steps = 0.5 ** torch.arange(_LS_STEPS, dtype=torch.float32, device=dev)  # (S,)
    W = torch.zeros((B, F, ns), dtype=torch.float32, device=dev)
    m = torch.zeros((B, N, ns), dtype=torch.float32, device=dev)

    def cg(h, g, active):
        """(I + X^T diag(h) X) d = -g per label, cg_max iterations."""
        d = torch.zeros_like(g)
        r = -g
        p = r
        rs = (r * r).sum(dim=1)  # (B, ns)
        tol2 = 1e-8 * rs
        for _ in range(cg_max):
            Hp = p + xt_apply(h * margins(p))
            pHp = (p * Hp).sum(dim=1)
            live = (rs > tol2) & active
            alpha = torch.where(live, rs / torch.clamp(pHp, min=1e-30), 0.0)[:, None, :]
            d = d + alpha * p
            r = r - alpha * Hp
            rs_new = (r * r).sum(dim=1)
            beta = torch.where(live, rs_new / torch.clamp(rs, min=1e-30), 0.0)[:, None, :]
            p = r + beta * p
            rs = rs_new
        return d

    for gamma in gammas:
        gnorm0 = None
        done = torch.zeros((B, ns), dtype=torch.bool, device=dev)
        for it in range(max_newton):
            g = W + xt_apply(c * _dxi(loss, y, y * m, gamma))
            gnorm = torch.linalg.vector_norm(g, dim=1)  # (B, ns)
            if gnorm0 is None:
                gnorm0 = gnorm
            active = ~done
            d = cg(_hess_w(loss, c, y * m, gamma), g, active)
            Xd = margins(d)
            gTd = (g * d).sum(dim=1)
            f0 = 0.5 * (W * W).sum(dim=1) + (c * _xi(loss, y * m, gamma)).sum(dim=1)
            s = steps[:, None, None, None]  # every trial step at once: (S, B, ·, ns)
            fs = 0.5 * ((W + s * d) ** 2).sum(dim=2) + (c * _xi(loss, y * (m + s * Xd), gamma)).sum(dim=2)
            armijo = fs <= f0 + 0.01 * steps[:, None, None] * gTd  # (S, B, ns)
            first = (armijo.cumsum(dim=0) == 0).sum(dim=0)  # index of the first accepted step
            step = torch.where(armijo.any(dim=0) & active, steps[first.clamp(max=_LS_STEPS - 1)], 0.0)
            W = W + step[:, None, :] * d
            m = m + step[:, None, :] * Xd
            done = done | (gnorm <= eps * torch.clamp(gnorm0, min=1e-12))
            if it + 1 < max_newton and all_converged(done):
                break
    return W


def _dense_contractions(X: torch.Tensor):
    """margins / xt_apply of a dense (B, N, F) X."""
    return (lambda W: torch.bmm(X, W)), (lambda G: torch.bmm(X.transpose(1, 2), G))


def solve_contractions(
    margins: Contraction, xt_apply: Contraction, y: torch.Tensor, c: torch.Tensor, F: int, *, loss, eps, max_newton, cg_max
) -> torch.Tensor:
    """Newton-CG over an X given by its two contractions, l1hinge with its
    continuation; returns W (B, F, ns).  The dense layouts pass ``torch.bmm``
    of one tensor; ``parallel.mesh.shard_solve_block`` passes X's row shards
    (margins concatenated, X^T G summed over the shards)."""
    gammas = _L1_GAMMA_STAGES if loss == "l1hinge" else (_L1_SMOOTH_GAMMA,)
    return _newton_cg(
        margins, xt_apply, y, c, F, loss=loss, eps=eps, max_newton=max_newton, cg_max=cg_max, gammas=gammas,
    )


def _solve_dense(X, y, c, *, loss, eps, max_newton, cg_max) -> torch.Tensor:
    """Newton-CG on a dense batched X (B, N, F)."""
    return solve_contractions(
        *_dense_contractions(X), y, c, X.shape[2], loss=loss, eps=eps, max_newton=max_newton, cg_max=cg_max
    )


def solve_block(
    X: torch.Tensor,  # (N, D) float32, bias column already appended
    y: torch.Tensor,  # (N, Lb) float32 in {+1, -1}
    c: torch.Tensor,  # (N, Lb) float32 >= 0; 0 where inactive
    *,
    loss: str = "sqhinge",
    eps: float = 0.01,
    max_newton: int = 20,
    cg_max: int = 10,
) -> torch.Tensor:
    """Solve the block of per-label primal problems; returns W (D, Lb)."""
    return _solve_dense(X[None], y[None], c[None], loss=loss, eps=eps, max_newton=max_newton, cg_max=cg_max)[0]


def solve_block_coded(
    X: torch.Tensor,  # (N, D) float32, bias column already appended
    codes: torch.Tensor,  # (N, Lb) uint8: 0 inactive, 1 positive, 2 negative
    Cp: float,
    Cn: float,
    R=None,  # (N, Lb) float32 positive costs, or None
    *,
    loss: str = "sqhinge",
    eps: float = 0.01,
    max_newton: int = 20,
    cg_max: int = 10,
) -> torch.Tensor:
    """:func:`solve_block` on the uint8 coded wire: y and c are decoded on the
    device from one (N, Lb) uint8 tensor, a quarter of the bytes of one
    float32 mask.  A positive costs Cp (times R when given), a negative Cn."""
    pos = codes == 1
    y = torch.where(pos, 1.0, -1.0)
    pos_cost = Cp * R if R is not None else float(Cp)
    c = torch.where(pos, pos_cost, torch.where(codes == 2, float(Cn), 0.0))
    return solve_block(X, y, c, loss=loss, eps=eps, max_newton=max_newton, cg_max=cg_max)


def solve_cluster_bucket(
    x_ids: torch.Tensor,  # (Cb, P, xcap) int32 local feature ids, pad id = F2
    x_vals: torch.Tensor,  # (Cb, P, xcap) float32, 0 where padded
    y: torch.Tensor,  # (Cb, P, ns) float32 +-1
    c: torch.Tensor,  # (Cb, P, ns) float32 cost, 0 inactive or padded
    *,
    F2: int,
    loss: str = "sqhinge",
    eps: float = 0.01,
    max_newton: int = 20,
    cg_max: int = 10,
) -> torch.Tensor:
    """Per-cluster training in each cluster's local feature space: every
    cluster's active rows (P) restricted to the F2 features they touch,
    densified on the device and solved together with a leading cluster axis.
    Sound because weights outside a cluster's feature union carry only the
    regulariser, so their optimum is 0.  Returns W_local (Cb, F2, ns)."""
    Cb, P, _ = x_ids.shape
    X = torch.zeros((Cb, P, F2 + 1), dtype=torch.float32, device=x_ids.device)
    X.scatter_add_(2, x_ids.long(), x_vals)
    return _solve_dense(X[:, :, :F2], y, c, loss=loss, eps=eps, max_newton=max_newton, cg_max=cg_max)


def solve_sparse_rows(
    x_ids: torch.Tensor,  # (P, xcap) int32 global feature ids, pad id = Db
    x_vals: torch.Tensor,  # (P, xcap) float32, 0 where padded
    y: torch.Tensor,  # (P, ns)
    c: torch.Tensor,  # (P, ns)
    *,
    Db: int,
    loss: str = "sqhinge",
    eps: float = 0.01,
    max_newton: int = 20,
    cg_max: int = 10,
) -> torch.Tensor:
    """Newton-CG with X as padded sparse rows in the global feature space,
    for clusters whose local dense layout does not fit (the top tree layers:
    every instance active, every feature touched).  W (Db+1, ns) keeps a
    padding row at Db, where padded slots point; their values are 0, so its
    gradient is exactly 0 and the row stays 0.  Returns W (Db, ns).

    X is densified to (P, Db+1) when that fits ``_GLOBAL_DENSE_BUDGET``;
    otherwise both contractions run over row chunks: margins gather W[ids],
    and X^T G sums ``vals * G`` into W's rows in a fixed order, so a solve
    repeats bit for bit (no float atomics): each chunk's slots are sorted by
    feature id once per solve, and each Newton-CG product sums the runs of
    equal ids (``torch_util.run_sums``) and adds them to distinct rows.  Both
    take one gamma stage: unlike the dense solvers, l1hinge has no
    continuation here, as in the JAX package."""
    P, xcap = x_ids.shape
    ns = y.shape[1]
    ids = x_ids.long()
    if P * (Db + 2) <= _GLOBAL_DENSE_BUDGET:
        Xd = torch.zeros((P, Db + 1), dtype=torch.float32, device=x_ids.device)
        Xd.scatter_add_(1, ids, x_vals)
        margins, xt_apply = _dense_contractions(Xd[None])
    else:
        pc = max(1, min(P, _SCATTER_CHUNK_ELEMENTS // max(1, xcap * ns)))
        chunks = [(ids[s : s + pc], x_vals[s : s + pc]) for s in range(0, P, pc)]
        plans = []  # per chunk: (distinct ids, run starts, run ends, row of each sorted slot, its value)
        for s, (i, v) in enumerate(chunks):
            flat = i.reshape(-1)
            order = torch.argsort(flat, stable=True)
            uniq, counts = torch.unique_consecutive(flat[order], return_counts=True)
            ends = counts.cumsum(0)
            plans.append((uniq, (ends - counts)[None], ends[None], order // xcap + s * pc, v.reshape(-1)[order]))

        def margins(W):  # (1, Db+1, ns) -> (1, P, ns)
            return torch.cat([torch.einsum("pxn,px->pn", W[0][i], v) for i, v in chunks])[None]

        def xt_apply(G):  # (1, P, ns) -> (1, Db+1, ns)
            out = torch.zeros((Db + 1, ns), dtype=torch.float32, device=G.device)
            for uniq, starts, ends, rows, vals in plans:
                out[uniq] += run_sums((vals[:, None] * G[0][rows])[None], starts, ends)[0]
            return out[None]

    W = _newton_cg(
        margins, xt_apply, y[None], c[None], Db + 1,
        loss=loss, eps=eps, max_newton=max_newton, cg_max=cg_max,
    )
    return W[0, :Db]


def loss_name(solver_type: str) -> str:
    st = solver_type.upper()
    if st in (SOLVER_SQHINGE, SOLVER_SQHINGE_DUAL):
        return "sqhinge"
    if st == "L2R_L1LOSS_SVC_DUAL":
        return "l1hinge"  # smoothed primal equivalent (see _L1_SMOOTH_GAMMA)
    if st in (SOLVER_LR, SOLVER_LR_PRIMAL):
        return "logistic"
    raise ValueError(f"unknown solver_type {solver_type!r}")


def prune_topk_device(W: torch.Tensor, threshold: float, K: int):
    """Weight pruning on the device: |w| < threshold -> 0, then the K largest
    |w| per label, ties to the lower feature id (a stable descending sort, as
    ``lax.top_k`` orders them).  Returns (idx (Lb, K) int32, vals (Lb, K)
    float32), vals 0 at dropped slots; only this sparse top-K is fetched."""
    aW = W.abs()
    aW = torch.where(aW >= threshold, aW, 0.0)
    mags, idx = torch.sort(aW.T, dim=1, descending=True, stable=True)
    mags, idx = mags[:, :K], idx[:, :K]
    vals = torch.where(mags > 0, torch.take_along_dim(W.T, idx, dim=1), 0.0)
    return idx.int(), vals


def count_above_threshold(W: torch.Tensor, threshold: float) -> torch.Tensor:
    """Max per-label count of |w| >= threshold (a 0-dim tensor): sizes the top-K fetch."""
    return (W.abs() >= threshold).sum(dim=0).max()
