"""Factorization machines for XMC retrieval, trained on a torch device.

The port of ``examples/fm-for-xmc/fm.py``, with its names and its model
folder (``fm.npz`` + ``params.json``), so a folder saved by either loads in
the other.  A second-order FM over (query, product) feature pairs,

    score(q, p) = wq . xq + wp . xp + < Vq^T xq, Vp^T xp >,

is trained with minibatch AdaGrad on a logistic pairwise loss (each
positive pair against ``neg_per_pos`` sampled products) plus L2, with an
optional held-out split that stops training when its loss rises.
``to_sip_embeddings`` appends two scalar lanes so a plain inner product gives
the score (the reference's "FM to SIP").

Training is an init and a fit: ``init_params`` draws the starting factors
from a ``torch.Generator`` (other numbers than the JAX package's
``jax.random``), and ``fit`` runs from any given parameters on the device
they lie on.  The epoch order and the negatives come from numpy's
``default_rng(seed)``, as in the JAX package.  The AdaGrad step is optax's:
accumulators start at 0.1 and a step is ``g * rsqrt(sum g^2 + 1e-7)``.

    python -m pecos_tpu_torch.examples.fm_for_xmc --demo [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import scipy.sparse as smat
import torch

from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.torch_util import DeviceLike, make_generator, resolve_device

# optax.adagrad's defaults
ADAGRAD_INIT = 0.1
ADAGRAD_EPS = 1e-7
_PARAM_NAMES = ("wq", "wp", "Vq", "Vp")


@dataclasses.dataclass
class FMParams:
    k: int = 8  # factorized dimensions
    epochs: int = 10
    l2: float = 2e-5
    lr: float = 2e-2  # AdaGrad learning rate
    batch_size: int = 1024
    neg_per_pos: int = 4  # sampled negatives per positive pair
    auto_stop: bool = True  # stop when the held-out loss rises
    seed: int = 0


def _dense(X) -> np.ndarray:
    return np.asarray(X.todense(), np.float32) if smat.issparse(X) else np.asarray(X, np.float32)


class FactorizationMachine:
    """FM over (query, product) feature pairs; the parameters are host arrays
    wq (dq,), wp (dp,), Vq (dq, k), Vp (dp, k)."""

    def __init__(self, wq, wp, Vq, Vp, params: FMParams):
        self.wq = wq
        self.wp = wp
        self.Vq = Vq
        self.Vp = Vp
        self.params = params

    @staticmethod
    def init_params(dq: int, dp: int, params: Optional[FMParams] = None, device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
        """The starting parameters on ``device``: zero linear weights, factors
        0.1 x N(0, 1) drawn from a torch.Generator seeded with params.seed."""
        params = params or FMParams()
        dev = resolve_device(device)
        gen = make_generator(params.seed, dev)
        return {
            "wq": torch.zeros(dq, device=dev),
            "wp": torch.zeros(dp, device=dev),
            "Vq": 0.1 * torch.randn((dq, params.k), generator=gen, device=dev),
            "Vp": 0.1 * torch.randn((dp, params.k), generator=gen, device=dev),
        }

    @classmethod
    def train(
        cls,
        Xq: smat.csr_matrix,  # (nq, dq) query features
        Y: smat.csr_matrix,  # (nq, np) positive pairs
        Xp: smat.csr_matrix,  # (np, dp) product features
        params: Optional[FMParams] = None,
        Xq_val: Optional[smat.csr_matrix] = None,
        Y_val: Optional[smat.csr_matrix] = None,
        device: DeviceLike = "cuda",
    ) -> "FactorizationMachine":
        """``init_params`` on ``device``, then ``fit``."""
        params = params or FMParams()
        theta = cls.init_params(Xq.shape[1], Xp.shape[1], params, device)
        return cls.fit(Xq, Y, Xp, theta, params, Xq_val=Xq_val, Y_val=Y_val)

    @classmethod
    def fit(
        cls,
        Xq: smat.csr_matrix,
        Y: smat.csr_matrix,
        Xp: smat.csr_matrix,
        theta: Dict[str, torch.Tensor],
        params: Optional[FMParams] = None,
        Xq_val: Optional[smat.csr_matrix] = None,
        Y_val: Optional[smat.csr_matrix] = None,
    ) -> "FactorizationMachine":
        """AdaGrad from the parameters ``theta`` (wq, wp, Vq, Vp tensors), on
        the device they lie on: ``epochs`` passes over the positive pairs of
        Y in numpy-shuffled batches (a last partial batch is dropped), each
        pair against ``neg_per_pos`` uniform products.  With a held-out split
        each epoch also reports its loss, and ``auto_stop`` ends training
        when it rises."""
        params = params or FMParams()
        rng = np.random.default_rng(params.seed)
        dev = theta["Vq"].device
        npr = Xp.shape[0]
        Xq_d = torch.from_numpy(_dense(Xq)).to(dev)
        Xp_d = torch.from_numpy(_dense(Xp)).to(dev)
        t = {n: torch.nn.Parameter(theta[n].detach().to(dev, torch.float32).clone()) for n in _PARAM_NAMES}
        acc = {n: torch.full_like(p, ADAGRAD_INIT, requires_grad=False) for n, p in t.items()}

        def pair_score(q_rows, p_rows):
            xq, xp = Xq_d[q_rows], Xp_d[p_rows]
            lin = xq @ t["wq"] + xp @ t["wp"]
            return lin + ((xq @ t["Vq"]) * (xp @ t["Vp"])).sum(dim=1)  # the O(dk) factorized form

        def step(q_rows, pos_rows, neg_rows):
            B, G = neg_rows.shape
            s_pos = pair_score(q_rows, pos_rows)
            s_neg = pair_score(q_rows.repeat_interleave(G), neg_rows.reshape(-1)).reshape(B, G)
            ll = torch.nn.functional.softplus(-(s_pos[:, None] - s_neg)).mean()
            loss = ll + params.l2 * sum((v * v).sum() for v in t.values())
            grads = torch.autograd.grad(loss, list(t.values()))
            with torch.no_grad():
                for (n, p), g in zip(t.items(), grads):
                    a = acc[n].add_(g * g)
                    p.sub_(params.lr * torch.where(a > 0, torch.rsqrt(a + ADAGRAD_EPS), 0.0) * g)
            return loss.detach()

        Yc = Y.tocoo()
        pairs = np.stack([Yc.row, Yc.col], axis=1)
        B = min(params.batch_size, len(pairs))
        val_pairs = None
        if Xq_val is not None and Y_val is not None:
            Yv = Y_val.tocoo()
            val_pairs = np.stack([Yv.row, Yv.col], axis=1)

        as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        prev_val = np.inf
        for epoch in range(params.epochs):
            order = rng.permutation(len(pairs))
            tot, nb = torch.zeros((), device=dev), 0
            for s in range(0, len(order) - B + 1, B):
                sel = pairs[order[s : s + B]]
                negs = rng.integers(0, npr, size=(B, params.neg_per_pos))
                tot += step(as_dev(sel[:, 0]), as_dev(sel[:, 1]), as_dev(negs))
                nb += 1
            msg = f"epoch {epoch + 1}/{params.epochs} train_loss={float(tot) / max(nb, 1):.5f}"
            if val_pairs is not None:
                vsel = val_pairs[: min(4096, len(val_pairs))]
                vneg = rng.integers(0, npr, size=(len(vsel), params.neg_per_pos))
                vl = _val_loss_host({n: p.detach().cpu().numpy() for n, p in t.items()}, Xq_val, Xp, vsel, vneg)
                msg += f" val_loss={vl:.5f}"
                if params.auto_stop and vl > prev_val:
                    print(msg + "  (auto-stop: validation loss rose)")
                    break
                prev_val = vl
            print(msg)
        return cls(*(t[n].detach().cpu().numpy() for n in _PARAM_NAMES), params)

    def score(self, Xq, Xp) -> np.ndarray:
        """Dense (nq, np) score matrix on the host (small problems, evaluation)."""
        Xq, Xp = _dense(Xq), _dense(Xp)
        lin = (Xq @ self.wq)[:, None] + (Xp @ self.wp)[None, :]
        return lin + (Xq @ self.Vq) @ (Xp @ self.Vp).T

    def to_sip_embeddings(self, Xq, Xp):
        """Shifted-inner-product embeddings: (Eq (nq, k+2), Ep (np, k+2)) with
        <Eq[i], Ep[j]> == score(i, j)."""
        Xq, Xp = _dense(Xq), _dense(Xp)
        ones_q = np.ones((Xq.shape[0], 1), np.float32)
        ones_p = np.ones((Xp.shape[0], 1), np.float32)
        Eq = np.hstack([Xq @ self.Vq, (Xq @ self.wq)[:, None], ones_q]).astype(np.float32)
        Ep = np.hstack([Xp @ self.Vp, ones_p, (Xp @ self.wp)[:, None]]).astype(np.float32)
        return Eq, Ep

    def save(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        np.savez(os.path.join(folder, "fm.npz"), wq=self.wq, wp=self.wp, Vq=self.Vq, Vp=self.Vp)
        with open(os.path.join(folder, "params.json"), "w") as f:
            json.dump(dataclasses.asdict(self.params), f, indent=1)

    @classmethod
    def load(cls, folder: str) -> "FactorizationMachine":
        with np.load(os.path.join(folder, "fm.npz")) as z:
            arrays = [z[n] for n in _PARAM_NAMES]
        with open(os.path.join(folder, "params.json")) as f:
            params = FMParams(**json.load(f))
        return cls(*arrays, params)


def _val_loss_host(theta, Xq_val, Xp, vsel, vneg) -> float:
    """Held-out pairwise loss on host arrays (small validation slices)."""
    Xqv, Xpd = _dense(Xq_val), _dense(Xp)

    def sc(qr, pr):
        xq, xp = Xqv[qr], Xpd[pr]
        return xq @ theta["wq"] + xp @ theta["wp"] + np.sum((xq @ theta["Vq"]) * (xp @ theta["Vp"]), axis=1)

    s_pos = sc(vsel[:, 0], vsel[:, 1])
    G = vneg.shape[1]
    s_neg = sc(np.repeat(vsel[:, 0], G), vneg.reshape(-1)).reshape(-1, G)
    return float(np.mean(np.logaddexp(0.0, -(s_pos[:, None] - s_neg))))


def synthetic_pairs(nq=512, npr=256, dq=64, dp=64, k_true=4, seed=0):
    """(Xq, Y, Xp, S): pairs whose relevance comes from cross terms between
    query and product features (each query's top 3 products under a hidden
    FM), which an inner-product model of either side alone cannot fit."""
    rng = np.random.default_rng(seed)
    Xq = rng.standard_normal((nq, dq)).astype(np.float32) * 0.5
    Xp = rng.standard_normal((npr, dp)).astype(np.float32) * 0.5
    Aq = rng.standard_normal((dq, k_true)).astype(np.float32)
    Ap = rng.standard_normal((dp, k_true)).astype(np.float32)
    S = (Xq @ Aq) @ (Xp @ Ap).T
    top = np.argsort(-S, axis=1)[:, :3]
    rows = np.repeat(np.arange(nq), 3)
    Y = smat.csr_matrix((np.ones(nq * 3, np.float32), (rows, top.ravel())), shape=(nq, npr))
    return smat.csr_matrix(Xq), Y, smat.csr_matrix(Xp), S


def demo(device: DeviceLike = "cuda", k=8, epochs=30, l2=2e-5, lr=0.2, batch_size=256, n_val=64, seed=0):
    """The example's demo: synthetic_pairs, the last n_val queries held out,
    8 negatives a pair.  Returns (model, held-out P@1, SIP max |error|,
    held-out scores)."""
    Xq, Y, Xp, _ = synthetic_pairs()
    fm = FactorizationMachine.train(
        Xq[:-n_val], Y[:-n_val], Xp,
        FMParams(k=k, epochs=epochs, l2=l2, lr=lr, batch_size=batch_size, neg_per_pos=8, seed=seed),
        Xq_val=Xq[-n_val:], Y_val=Y[-n_val:], device=device,
    )
    S = fm.score(Xq[-n_val:], Xp)
    truth = np.asarray(Y[-n_val:].todense())
    p1 = float(np.mean(truth[np.arange(n_val), S.argmax(axis=1)] > 0))
    Eq, Ep = fm.to_sip_embeddings(Xq[-n_val:], Xp)
    return fm, p1, float(np.abs(Eq @ Ep.T - S).max()), S


def main(args=None):
    ap = argparse.ArgumentParser(description="factorization machines for XMC retrieval")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--q-trn", help="query features npz/npy")
    ap.add_argument("--qp-trn", help="positive pair matrix npz")
    ap.add_argument("--p-feat", help="product features npz/npy")
    ap.add_argument("--model", default=os.path.join(tempfile.gettempdir(), "fm_model"))
    ap.add_argument("-k", type=int, default=8)
    ap.add_argument("-t", "--epochs", type=int, default=30)
    ap.add_argument("-l", "--l2", type=float, default=2e-5)
    ap.add_argument("-r", "--lr", type=float, default=0.2)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(args)

    if args.demo:
        fm, p1, sip_err, _ = demo(args.device, k=args.k, epochs=args.epochs, l2=args.l2, lr=args.lr,
                                  batch_size=args.batch_size)
        print(f"held-out P@1 = {p1:.3f}")
        print(f"SIP embedding max |error| = {sip_err:.2e}")
        fm.save(args.model)
        print(f"model saved to {args.model}")
        return

    Xq = smat_util.load_matrix(args.q_trn).tocsr()
    Y = smat_util.load_matrix(args.qp_trn).tocsr()
    Xp = smat_util.load_matrix(args.p_feat).tocsr()
    t0 = time.time()
    fm = FactorizationMachine.train(
        Xq, Y, Xp, FMParams(k=args.k, epochs=args.epochs, l2=args.l2, lr=args.lr, batch_size=args.batch_size),
        device=args.device,
    )
    print(f"trained in {time.time() - t0:.1f}s")
    fm.save(args.model)


if __name__ == "__main__":
    main()
