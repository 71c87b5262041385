"""TransformerMatcher: one fine-tuning level of XR-Transformer (counterpart of
``pecos_tpu/xmc/xtransformer/matcher.py``).

train: tokenize once, bootstrap the head (inherit the parent's rows through
C, fit a linear model on the parent's embeddings, or random), draw each
instance's active labels (positives, then negatives of its matched
clusters), and fine-tune the encoder and head together on the squared hinge
with AdamW, a warmup-then-linear-decay schedule, global-norm clipping and
gradient accumulation; then predict the training set and, unless the
ensemble is transformer-only, train a concat ``MLModel`` on [X_feat ||
l2norm(embeddings)].

What follows the JAX package exactly, so the two train alike from one seed:
the numpy draws (active labels, shuffles, head init); the schedule, whose
first step has rate 0.0 (the moments move, the weights do not); optax's
clip (scale by max_norm / norm when norm >= max_norm); AdamW's decay of
every parameter; accumulation as the mean of the micro-batches' gradients.
Dropout draws from torch's generator seeded from TrainParams.seed (forked,
so the caller's state is untouched); it cannot draw JAX's bits.

With ``mesh=`` (a ``parallel.mesh.Mesh``) the batch is split over the mesh's
devices, each holding a replica of the encoder and head; the gradients are
summed on the first device, and the optimizer's moments are split over every
device (``parallel.mesh.shard_opt_state``, ZeRO stage 1).
"""

from __future__ import annotations

import copy
import dataclasses as dc
import functools
import json
import logging
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as smat
import torch

import pecos_tpu_torch
from pecos_tpu_torch.utils import profile_util, smat_util
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device
from pecos_tpu_torch.xmc.postprocessor import PostProcessor
from . import moe, network
from .module import CorpusTokens, MLProblemWithText, build_active_label_batches, tokenize_corpus

LOGGER = logging.getLogger(__name__)

# float32 elements of one block of dense label scores at predict
_SCORE_BLOCK = 1 << 26


def lr_lambda(total_steps: int, warmup_steps: int):
    """The JAX package's schedule as a factor of the peak rate at optimizer
    step s (0 for the first): s / warmup during the warmup, then linear
    decay to 0 over the remaining steps (warmup at least 1)."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps - warmup, 1)

    def factor(step: int) -> float:
        if step < warmup:
            return step / warmup
        return max(0.0, 1.0 - (step - warmup) / decay)

    return factor


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient times max_norm /
    norm when the global norm reaches max_norm (torch's clip_grad_norm_ adds
    1e-6 to the norm).  No host sync.  Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.device))
    return norm


def _cuda_indices(devices) -> List[int]:
    return sorted({d.index for d in devices if d.type == "cuda"})


class _Replica:
    """One mesh slot's copy of the trainable tensors (the first slot's are the
    model's own): the encoder and the head's W and b."""

    def __init__(self, encoder, W, b, device):
        self.encoder, self.W, self.b, self.device = encoder, W, b, device

    def params(self) -> List[torch.Tensor]:
        return list(self.encoder.parameters()) + [self.W, self.b]

    @classmethod
    def copy_of(cls, master: "_Replica", device) -> "_Replica":
        enc = copy.deepcopy(master.encoder).to(device)
        W, b = (t.detach().clone().to(device).requires_grad_(True) for t in (master.W, master.b))
        return cls(enc, W, b, device)

    def loss(self, batch: dict, denom: float) -> torch.Tensor:
        dev = self.device
        ii, am = batch["input_ids"].to(dev), batch["attention_mask"].to(dev)
        emb = network.pooled_embedding(self.encoder(input_ids=ii, attention_mask=am), am)
        logits = network.head_logits(self.W, self.b, emb, batch["label_ids"].to(dev))
        return network.squared_hinge_loss(logits, batch["targets"].to(dev), batch["costs"].to(dev), denom)


class TransformerMatcher(pecos_tpu_torch.BaseClass):
    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        model_shortcut: str = "distilbert-base-uncased"
        model_type: str = "distilbert"
        model_config: Optional[dict] = None  # random-init widths (+ vocab_file) in place of a folder
        negative_sampling: str = "tfn"
        loss_function: str = "squared-hinge"
        bootstrap_method: str = "inherit"  # inherit | linear | no-bootstrap
        truncate_length: int = 128
        batch_size: int = 32
        learning_rate: float = 5e-5
        weight_decay: float = 0.01
        warmup_steps: int = 0
        num_train_epochs: int = 1
        max_steps: int = 0
        max_active_matching_labels: int = 64
        max_grad_norm: float = 1.0
        gradient_accumulation_steps: int = 1
        save_steps: int = 0  # eval on the validation set + keep the best every N optimizer steps
        init_model_dir: str = ""  # warm start from a saved TransformerMatcher
        threshold: float = 0.1  # concat-model weight pruning
        cost_sensitive_ranker: bool = False
        Cp: float = 1.0
        Cn: float = 1.0
        seed: int = 0
        threads: int = -1  # kept so params files load

    @dc.dataclass
    class PredParams(pecos_tpu_torch.BaseParams):
        only_topk: int = 20
        post_processor: str = "noop"
        truncate_length: int = 128
        # transformer-only | concat-only | average | rank_average |
        # sigmoid_average | softmax_average | round_robin: any other than
        # transformer-only trains a per-level concat MLModel on
        # [X_feat || embeddings] when X_feat is given
        ensemble_method: str = "transformer-only"

    def __init__(self, encoder, tokenizer, head: network.XMCHead, C=None, train_params=None, pred_params=None,
                 concat_model=None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.encoder = encoder.to(self.device).eval()
        self.tokenizer = tokenizer
        self.head = head
        self.C = C.tocsc() if C is not None else None
        self.train_params = self.TrainParams.from_dict(train_params)
        self.pred_params = self.PredParams.from_dict(pred_params)
        self.concat_model = concat_model
        # what train measured: each micro-step's loss, the seconds of its step
        # loop (synchronized), and the optimizer-state bytes each mesh slot held
        self.train_losses: Optional[np.ndarray] = None
        self.train_seconds: Optional[float] = None
        self.moment_bytes: Optional[List[int]] = None

    @property
    def nr_labels(self):
        return self.head.nr_labels

    @property
    def hidden_size(self):
        return self.head.W.shape[1]

    # ------------------------------------------------------------------ setup
    @classmethod
    def download_model(cls, train_params: "TransformerMatcher.TrainParams"):
        """(encoder, tokenizer): random-init from ``model_config`` (with a
        WordPiece ``vocab_file``), or a local ``from_pretrained`` folder named
        by ``model_shortcut`` (torch weights, or the JAX package's Flax file)."""
        if train_params.model_config is not None:
            encoder = network.random_encoder(train_params.model_type, train_params.model_config, seed=train_params.seed)
            vocab_file = train_params.model_config.get("vocab_file")
            if not vocab_file:
                raise ValueError("model_config requires 'vocab_file' for the tokenizer")
            if train_params.model_type not in network._WORDPIECE:
                raise NotImplementedError(
                    f"model_config['vocab_file'] builds a WordPiece tokenizer ({', '.join(network._WORDPIECE)}); "
                    f"for {train_params.model_type!r} give model_shortcut a folder with its tokenizer"
                )
            return encoder, network.wordpiece_tokenizer(vocab_file)
        import transformers

        name = train_params.model_shortcut
        network.check_pretrained(network.resolve_encoder(train_params.model_type)[1], f"model_shortcut {name!r}")
        tokenizer = transformers.AutoTokenizer.from_pretrained(name)
        if os.path.isdir(name):
            return network.load_encoder(name, train_params.model_type), tokenizer
        return network.resolve_encoder(train_params.model_type)[1].from_pretrained(name).eval(), tokenizer

    # ------------------------------------------------------------------ train
    @classmethod
    def train(
        cls,
        prob: MLProblemWithText,
        csr_codes: Optional[smat.csr_matrix] = None,
        C: Optional[smat.spmatrix] = None,
        R: Optional[smat.spmatrix] = None,
        train_params=None,
        pred_params=None,
        parent_matcher: Optional["TransformerMatcher"] = None,
        val_prob: Optional[MLProblemWithText] = None,
        val_csr_codes: Optional[smat.csr_matrix] = None,
        mesh=None,
        device: DeviceLike = "cuda",
        **kwargs,
    ) -> Tuple["TransformerMatcher", smat.csr_matrix, np.ndarray]:
        """Fine-tune one level on ``device`` (with ``mesh``: the mesh's first
        device); returns (matcher, training-set predictions, training-set
        embeddings).  ``val_prob`` with TrainParams.save_steps: every
        save_steps optimizer steps the validation P@1 of the live weights is
        computed and the best weights are restored at the end."""
        train_params = cls.TrainParams.from_dict(train_params)
        train_params.override_with_kwargs(kwargs)
        network.check_pretrained(network.resolve_encoder(train_params.model_type)[1], "TransformerMatcher.train")
        pred_params = cls.PredParams.from_dict(pred_params)
        pred_params.truncate_length = train_params.truncate_length
        slots = [resolve_device(device)] if mesh is None else [d for row in mesh.devices for d in row]
        device = slots[0]
        rng = np.random.default_rng(train_params.seed)

        if parent_matcher is None and train_params.init_model_dir:
            parent_matcher = cls.load(train_params.init_model_dir, device=device)
            LOGGER.info("warm start from %s", train_params.init_model_dir)
        if parent_matcher is not None:
            encoder, tokenizer = parent_matcher.encoder, parent_matcher.tokenizer
        else:
            encoder, tokenizer = cls.download_model(train_params)
        encoder = encoder.to(device)

        toks = tokenize_corpus(tokenizer, prob.X_text, train_params.truncate_length)
        N, L = toks["input_ids"].shape[0], prob.nr_labels
        hidden = network.hidden_size(encoder.config)

        # ---- head bootstrap
        if train_params.bootstrap_method == "inherit" and parent_matcher is not None and C is not None:
            head = network.XMCHead.inherit(parent_matcher.head, C, seed=train_params.seed)
        elif train_params.bootstrap_method == "linear" and parent_matcher is not None:
            from pecos_tpu_torch.xmc import MLModel, MLProblem

            boot = MLModel.train(
                MLProblem(parent_matcher._embed(toks), prob.Y.tocsc()),
                train_params=MLModel.TrainParams(threshold=0.0, max_newton_iter=8), device=device,
            )
            head = network.XMCHead.from_linear(np.asarray(boot.W.todense()))
        else:
            head = network.XMCHead.random(L, hidden, seed=train_params.seed)

        # ---- active label sets: negatives of the matched clusters in label space
        M_label = None
        if C is not None:
            M_cluster = (prob.Y @ C).tocsr() if csr_codes is None else csr_codes.tocsr()
            M_label = (M_cluster @ C.T.tocsr()).tocsr()
        label_ids, targets, costs = build_active_label_batches(
            prob.Y.tocsr(), M_label, R, max_active=min(train_params.max_active_matching_labels, L), pad_label=L,
            rng=rng, Cp=train_params.Cp, Cn=train_params.Cn,
        )

        # ---- optimizer and schedule
        B = train_params.batch_size
        steps_per_epoch = max(1, N // B)
        total_steps = train_params.max_steps if train_params.max_steps > 0 else steps_per_epoch * train_params.num_train_epochs
        accum = max(1, train_params.gradient_accumulation_steps)
        W = torch.from_numpy(head.W).to(device).requires_grad_(True)
        b = torch.from_numpy(head.b).to(device).requires_grad_(True)
        reps = [_Replica(encoder, W, b, device)]
        opt = torch.optim.AdamW(reps[0].params(), lr=train_params.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=train_params.weight_decay)
        if mesh is not None:
            from pecos_tpu_torch.parallel.mesh import shard_opt_state

            opt, n_sharded = shard_opt_state(opt, mesh)
            LOGGER.info("sharded %d optimizer-state tensors over the mesh", n_sharded)
            reps += [_Replica.copy_of(reps[0], dev) for dev in slots[1:]]
            n = len(slots)
            B = max(n, (B // n) * n)  # the batch divisible by the mesh size
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda(total_steps, train_params.warmup_steps))
        rep_params = [r.params() for r in reps]
        part = B // len(reps)

        def optimizer_step():
            if len(reps) > 1:  # the replicas' gradients summed on the first device, in slot order
                for ps in zip(*rep_params):
                    grads = [p.grad.to(device) for p in ps if p.grad is not None]
                    ps[0].grad = functools.reduce(torch.add, grads) if grads else None
            clip_by_global_norm_([p.grad for p in rep_params[0] if p.grad is not None], train_params.max_grad_norm)
            opt.step()
            sched.step()
            for ps in rep_params:
                for p in ps:
                    p.grad = None
            with torch.no_grad():
                for ps in rep_params[1:]:
                    for p, q in zip(rep_params[0], ps):
                        q.copy_(p)

        # ---- optional validation scorer (checkpoint-best)
        val_p1 = None
        if val_prob is not None and train_params.save_steps > 0:
            val_toks = tokenize_corpus(tokenizer, val_prob.X_text, train_params.truncate_length)
            Y_val = val_prob.Y.tocsr()

            def val_p1() -> float:
                with torch.no_grad():
                    emb = network.encode_batches(encoder, val_toks, device, batch_size=B)
                    top1 = torch.argmax(emb @ W[:L].T + b[:L], dim=1).cpu().numpy().copy()
                return float(np.asarray(Y_val[np.arange(len(top1)), top1]).sum()) / max(len(top1), 1)

        best_p1, best = -1.0, None
        losses: List[torch.Tensor] = []
        step = 0
        total_micro = total_steps * accum
        order = np.arange(N)
        t_loop = time.perf_counter()
        encoder.train()
        for r in reps[1:]:
            r.encoder.train()
        with torch.random.fork_rng(devices=_cuda_indices(slots)):
            torch.manual_seed(train_params.seed)
            for _epoch in range(max(1, train_params.num_train_epochs * accum)):
                rng.shuffle(order)
                for s in range(0, N - B + 1, B) if N >= B else [0]:
                    idx = order[s : s + B]
                    if len(idx) < B:  # one batch of fewer rows than B: wrap around
                        idx = np.concatenate([idx, np.resize(order, B - len(idx))])
                    denom = float(max(int((costs[idx] > 0).sum()), 1))
                    loss = None
                    for i, rep in enumerate(reps):
                        sl = idx[i * part : (i + 1) * part]
                        batch = {
                            "input_ids": torch.from_numpy(toks["input_ids"][sl].astype(np.int64)),
                            "attention_mask": torch.from_numpy(toks["attention_mask"][sl].astype(np.int64)),
                            "label_ids": torch.from_numpy(label_ids[sl].astype(np.int64)),
                            "targets": torch.from_numpy(targets[sl]),
                            "costs": torch.from_numpy(costs[sl]),
                        }
                        li = rep.loss(batch, denom)
                        (li / accum).backward()
                        li = li.detach().to(device)
                        loss = li if loss is None else loss + li
                    losses.append(loss)
                    step += 1
                    if step % accum == 0:
                        optimizer_step()
                    if step % 50 == 0:
                        LOGGER.info(f"step {step // accum}/{total_steps} loss={float(loss):.5f}")
                    if val_p1 is not None and step % (train_params.save_steps * accum) == 0:
                        p1 = val_p1()
                        LOGGER.info(f"val P@1 at step {step // accum}: {p1:.4f}")
                        if p1 > best_p1:
                            best_p1 = p1
                            best = ({k: v.detach().clone() for k, v in encoder.state_dict().items()},
                                    W.detach().clone(), b.detach().clone())
                    if step >= total_micro:
                        break
                if step >= total_micro:
                    break
        if best is not None:  # the last steps may still win; else restore the best
            p1 = val_p1()
            if p1 > best_p1:
                best_p1 = p1
            else:
                encoder.load_state_dict(best[0])
                with torch.no_grad():
                    W.copy_(best[1])
                    b.copy_(best[2])
            LOGGER.info(f"best val P@1: {best_p1:.4f}")
        train_losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
        train_seconds = time.perf_counter() - t_loop
        moment_bytes = opt.moment_bytes() if mesh is not None else [
            sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values() if v.dim() > 0)]
        del reps, rep_params, opt, sched
        encoder.eval()

        head = network.XMCHead(W=W.detach().cpu().numpy(), b=b.detach().cpu().numpy())
        matcher = cls(encoder, tokenizer, head, C=C, train_params=train_params, pred_params=pred_params, device=device)
        matcher.train_losses, matcher.train_seconds, matcher.moment_bytes = train_losses, train_seconds, moment_bytes
        trn_pred, trn_emb = matcher._predict_tokens(toks, csr_codes, matcher.get_pred_params())

        # ---- per-level concat model
        if pred_params.ensemble_method != "transformer-only" and getattr(prob, "X_feat", None) is not None:
            from pecos_tpu_torch.xmc import MLModel, MLProblem

            X_cat = cls.concat_features(prob.X_feat, trn_emb)
            M_cluster = None
            if C is not None:
                M_cluster = csr_codes if csr_codes is not None else (prob.Y @ C).tocsr()
            R_rank = smat_util.normalize(prob.Y.tocsr(), axis=1, norm="l1") if train_params.cost_sensitive_ranker else None
            lprob = MLProblem(X_cat, prob.Y.tocsc(), C=C if M_cluster is not None else None, M=M_cluster, R=R_rank)
            matcher.concat_model = MLModel.train(
                lprob, train_params=MLModel.TrainParams(threshold=train_params.threshold), device=device
            )
            concat_pred = matcher.concat_model.predict(
                X_cat, csr_codes=csr_codes, only_topk=pred_params.only_topk, post_processor=pred_params.post_processor
            )
            trn_pred = cls.ensemble_prediction(trn_pred, concat_pred, pred_params.only_topk, pred_params.ensemble_method)
        return matcher, trn_pred, trn_emb

    @staticmethod
    def concat_features(X_feat, emb: np.ndarray) -> smat.csr_matrix:
        """[X_feat || l2-normalized embeddings] (span ``pecos.concat``)."""
        with profile_util.span("pecos.concat"):
            emb_norm = smat_util.normalize(np.asarray(emb, np.float32), axis=1, norm="l2")
            if X_feat is None:
                return smat.csr_matrix(emb_norm)
            return smat_util.hstack_csr([X_feat.tocsr(), smat.csr_matrix(emb_norm)])

    # ------------------------------------------------------------------ predict
    @staticmethod
    def _fetch(emb: torch.Tensor) -> np.ndarray:
        """The embeddings on the host (span ``pecos.embed_fetch``); the
        encoder's device time is settled, and its expert layers' counts are
        moved into the registry (``moe.take_counts``), once the copy has
        waited for it."""
        with profile_util.span("pecos.embed_fetch"):
            out = emb.cpu().numpy()
        profile_util.settle()
        moe.take_counts(emb.device)
        return out

    def _embed(self, toks, batch_size: int = 256) -> np.ndarray:
        return self._fetch(network.encode_batches(self.encoder, toks, self.device, batch_size))

    def _topk(self, emb: torch.Tensor, csr_codes, pred_params) -> smat.csr_matrix:
        """The top-k labels of the head's scores on the device, blocks of rows
        at a time.  With a prior (csr_codes over C's clusters) a label of an
        inactive cluster scores -inf, then -1e30, and still enters the top-k
        of a row with fewer than k active labels, as in the JAX package."""
        pp = PostProcessor.get(pred_params.post_processor)
        L, dev = self.nr_labels, self.device
        k = min(pred_params.only_topk, L)
        W = torch.from_numpy(self.head.W[:L]).to(dev)
        b = torch.from_numpy(self.head.b[:L]).to(dev)
        parents = None
        if csr_codes is not None and self.C is not None:
            parents = torch.from_numpy(self.C.tocsr().indices.astype(np.int64)).to(dev)
            csr_codes = csr_codes.tocsr()
        N = emb.shape[0]
        rows = max(1, _SCORE_BLOCK // max(L, 1))
        idx, vals = [], []
        with torch.no_grad():
            for s in range(0, N, rows):
                val = pp.transform_torch(emb[s : s + rows] @ W.T + b)
                if parents is not None:
                    prior = torch.from_numpy(csr_codes[s : s + rows].toarray().astype(np.float32)).to(dev)[:, parents]
                    val = torch.where(prior != 0, pp.combiner_torch(val, prior), float("-inf"))
                val = torch.where(torch.isfinite(val), val, torch.full_like(val, -1e30))
                v, i = torch.topk(val, k, dim=1)
                idx.append(i.cpu())
                vals.append(v.cpu())
        if not idx:
            return smat.csr_matrix((N, L), dtype=np.float32)
        i, v = torch.cat(idx).numpy(), torch.cat(vals).numpy()
        return smat.csr_matrix((v.ravel(), i.ravel(), np.arange(0, (N + 1) * k, k)), shape=(N, L))

    def predict(
        self,
        corpus: Sequence[str],
        csr_codes: Optional[smat.csr_matrix] = None,
        pred_params=None,
        X_feat: Optional[smat.spmatrix] = None,
        **kwargs,
    ) -> Tuple[smat.csr_matrix, np.ndarray]:
        """(predictions over this level's labels, pooled embeddings).  With a
        concat model, ``X_feat`` and an ensembling ``ensemble_method``, the
        head's predictions are ensembled with the concat model's."""
        pred_params = self.get_pred_params() if pred_params is None else self.PredParams.from_dict(pred_params)
        pred_params.override_with_kwargs(kwargs)
        toks = CorpusTokens(self.tokenizer, corpus, pred_params.truncate_length)
        return self._predict_tokens(toks, csr_codes, pred_params, X_feat)

    def _predict_tokens(self, toks, csr_codes, pred_params, X_feat=None) -> Tuple[smat.csr_matrix, np.ndarray]:
        emb_dev = network.encode_batches(self.encoder, toks, self.device)
        P = self._topk(emb_dev, csr_codes, pred_params)
        emb = self._fetch(emb_dev)
        if self.concat_model is not None and pred_params.ensemble_method != "transformer-only":
            concat_pred = self.concat_model.predict(
                self.concat_features(X_feat, emb), csr_codes=csr_codes, only_topk=pred_params.only_topk,
                post_processor=pred_params.post_processor,
            )
            P = self.ensemble_prediction(P, concat_pred, pred_params.only_topk, pred_params.ensemble_method)
        return P, emb.astype(np.float32)

    def get_pred_params(self):
        return copy.deepcopy(self.pred_params)

    @staticmethod
    def ensemble_prediction(transformer_pred_csr, concat_pred_csr, only_topk: int, ens_method: str):
        """The transformer's and the concat ranker's predictions combined by
        ``ens_method``, rows sorted and cut to only_topk."""
        if transformer_pred_csr.shape != concat_pred_csr.shape:
            raise ValueError("transformer/concat prediction shapes differ")
        if ens_method == "concat-only":
            out = concat_pred_csr
        elif ens_method == "transformer-only":
            out = transformer_pred_csr
        elif ens_method in ("average", "rank_average", "sigmoid_average", "softmax_average", "round_robin"):
            out = getattr(smat_util.CsrEnsembler, ens_method)(transformer_pred_csr.tocsr(), concat_pred_csr.tocsr())
        else:
            raise ValueError(f"unknown ens_method {ens_method!r}")
        return smat_util.sorted_csr(out.tocsr(), only_topk=only_topk)

    # ------------------------------------------------------------------ persist
    def save(self, folder: str):
        """param.json, encoder/ (torch's save_pretrained), tokenizer/,
        head.npz, C.npz and concat_model/: the JAX package's folder, with the
        encoder in safetensors, which its loader converts."""
        network.check_pretrained(type(self.encoder), "TransformerMatcher.save")
        os.makedirs(folder, exist_ok=True)
        param = self.append_meta(
            {"model": type(self).__name__, "train_params": self.train_params.to_dict(), "pred_params": self.pred_params.to_dict()}
        )
        with open(os.path.join(folder, "param.json"), "w") as f:
            json.dump(param, f, indent=True)
        self.encoder.save_pretrained(os.path.join(folder, "encoder"))
        self.tokenizer.save_pretrained(os.path.join(folder, "tokenizer"))
        np.savez(os.path.join(folder, "head.npz"), W=self.head.W, b=self.head.b)
        if self.C is not None:
            smat_util.save_matrix(os.path.join(folder, "C.npz"), self.C)
        if self.concat_model is not None:
            self.concat_model.save(os.path.join(folder, "concat_model"))

    @classmethod
    def load(cls, folder: str, device: DeviceLike = "cuda") -> "TransformerMatcher":
        """A folder saved by this package or the JAX package, on ``device``."""
        import transformers

        with open(os.path.join(folder, "param.json")) as f:
            param = json.load(f)
        strip = lambda d: {k: v for k, v in d.items() if k != "__meta__"}
        train_params = cls.TrainParams.from_dict(strip(param["train_params"]))
        encoder = network.load_encoder(os.path.join(folder, "encoder"), train_params.model_type)
        tokenizer = transformers.AutoTokenizer.from_pretrained(os.path.join(folder, "tokenizer"))
        with np.load(os.path.join(folder, "head.npz")) as z:
            head = network.XMCHead(W=z["W"], b=z["b"])
        C_path = os.path.join(folder, "C.npz")
        C = smat_util.load_matrix(C_path) if os.path.exists(C_path) else None
        concat_model = None
        if os.path.isdir(os.path.join(folder, "concat_model")):
            from pecos_tpu_torch.xmc import MLModel

            concat_model = MLModel.load(os.path.join(folder, "concat_model"), device=device)
        return cls(encoder, tokenizer, head, C=C, train_params=train_params, pred_params=strip(param["pred_params"]),
                   concat_model=concat_model, device=device)
