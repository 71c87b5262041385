"""XTransformer: the three-phase XR-Transformer recipe (counterpart of
``pecos_tpu/xmc/xtransformer/model.py``).

Phase 1: a preliminary label tree from PIFA(Y, X_feat) (PII without X_feat).
Phase 2: the encoder fine-tuned down the tree, one TransformerMatcher per
level of at most ``max_match_clusters`` labels, each level's negatives from
the one above's predictions; or, with ``do_fine_tune=False``, a frozen
encoder (a saved matcher or the model as it is).
Phase 3: the concat ranker, an ``XLinearModel`` trained on
X_cat = [X_feat || l2norm(embeddings)] over a refined tree.  Its predict runs
K1 on every plabel level: each query row carries the encoder's dense columns
beside its TF-IDF nonzeros.

predict = encoder embeddings -> X_cat -> ranker beam search; encode gives
the embeddings.  The folder is the JAX package's: param.json,
text_encoder/ (a TransformerMatcher) and concat_model/ (an XLinearModel).
"""

from __future__ import annotations

import dataclasses as dc
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as smat

import pecos_tpu_torch
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.cluster_util import ClusterChain
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device
from pecos_tpu_torch.xmc import Indexer, LabelEmbeddingFactory
from pecos_tpu_torch.xmc.xlinear import XLinearModel
from . import network
from .matcher import TransformerMatcher
from .module import CorpusTokens, MLProblemWithText

LOGGER = logging.getLogger(__name__)


class XTransformer(pecos_tpu_torch.BaseClass):
    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        do_fine_tune: bool = True
        only_encoder: bool = False
        max_match_clusters: int = 32768
        fix_clustering: bool = False
        matcher_params_chain: Optional[TransformerMatcher.TrainParams] = None
        ranker_params: Optional[XLinearModel.TrainParams] = None
        preliminary_indexer_params: Optional[dict] = None
        refined_indexer_params: Optional[dict] = None

    @dc.dataclass
    class PredParams(pecos_tpu_torch.BaseParams):
        matcher_params_chain: Optional[TransformerMatcher.PredParams] = None
        ranker_params: Optional[XLinearModel.PredParams] = None
        ens_method: str = "transformer-only"  # kept so params files load

    def __init__(self, text_encoder: TransformerMatcher, concat_model: Optional[XLinearModel]):
        self.text_encoder = text_encoder
        self.concat_model = concat_model

    @property
    def nr_labels(self):
        return self.concat_model.nr_labels if self.concat_model is not None else self.text_encoder.nr_labels

    @property
    def device(self):
        return self.text_encoder.device

    # ------------------------------------------------------------------ train
    @classmethod
    def train(
        cls,
        prob: MLProblemWithText,
        clustering: Optional[ClusterChain] = None,
        train_params=None,
        pred_params=None,
        device: DeviceLike = "cuda",
        **kwargs,
    ) -> "XTransformer":
        """The three phases on ``device``; kwargs go to the ranker's
        ``XLinearModel.train`` (threshold, beam_size, only_topk, ...)."""
        device = resolve_device(device)
        train_params = cls.TrainParams.from_dict(train_params)
        matcher_params = TransformerMatcher.TrainParams.from_dict(train_params.matcher_params_chain)
        Y, X_feat = prob.Y.tocsc(), prob.X_feat

        # ---- phase 1: the preliminary tree
        if clustering is None:
            label_feat = (LabelEmbeddingFactory.create(Y, X_feat, method="pifa") if X_feat is not None
                          else LabelEmbeddingFactory.create(Y, method="pii"))
            clustering = Indexer.gen(label_feat, device=device, **dict(train_params.preliminary_indexer_params or {}))
        clustering = ClusterChain(clustering)

        # ---- phase 2: fine-tune down the tree, or a frozen encoder
        matcher = M_pred = trn_emb = None
        if train_params.do_fine_tune:
            Y_chain = [Y.tocsr()]  # labels at each level of the chain
            for C in reversed(clustering[1:]):
                Y_chain.insert(0, (Y_chain[0] @ C).tocsr())
            levels = [d for d in range(len(clustering)) if clustering[d].shape[0] <= train_params.max_match_clusters]
            for li, d in enumerate(levels):
                Y_d = smat_util.binarized(Y_chain[d])
                LOGGER.info(f"fine-tuning level {li + 1}/{len(levels)} (labels={Y_d.shape[1]})")
                matcher, M_pred, trn_emb = TransformerMatcher.train(
                    MLProblemWithText(prob.X_text, Y_d, X_feat=X_feat), csr_codes=M_pred,
                    C=clustering[d] if d > 0 else None, train_params=matcher_params, parent_matcher=matcher,
                    device=device,
                )
        else:
            if matcher_params.init_model_dir:
                matcher = TransformerMatcher.load(matcher_params.init_model_dir, device=device)
                LOGGER.info("loaded frozen encoder from %s", matcher_params.init_model_dir)
            else:
                encoder, tokenizer = TransformerMatcher.download_model(matcher_params)
                head = network.XMCHead.random(Y.shape[1], network.hidden_size(encoder.config), seed=matcher_params.seed)
                matcher = TransformerMatcher(
                    encoder, tokenizer, head, train_params=matcher_params,
                    pred_params=TransformerMatcher.PredParams(truncate_length=matcher_params.truncate_length),
                    device=device,
                )
        if train_params.only_encoder:
            return cls(matcher, None)

        # ---- phase 3: the concat ranker
        if trn_emb is None:
            _, trn_emb = matcher.predict(prob.X_text)
        X_cat = TransformerMatcher.concat_features(X_feat, trn_emb)
        if train_params.fix_clustering:
            refined = clustering
        else:
            label_feat = LabelEmbeddingFactory.create(Y, X_cat, method="pifa")
            refined = Indexer.gen(label_feat, device=device, **dict(train_params.refined_indexer_params or {}))
        ranker = XLinearModel.train(X_cat, Y, C=refined, train_params=train_params.ranker_params, device=device, **kwargs)
        return cls(matcher, ranker)

    # ------------------------------------------------------------------ predict
    def encode(self, corpus: Sequence[str], **kwargs) -> np.ndarray:
        """The fine-tuned encoder's pooled embeddings of ``corpus`` (the
        matcher's head is not scored).  kwargs: truncate_length."""
        matcher = self.text_encoder
        pred_params = matcher.get_pred_params().override_with_kwargs(kwargs)
        return matcher._embed(CorpusTokens(matcher.tokenizer, corpus, pred_params.truncate_length))

    def predict(
        self,
        corpus: Sequence[str],
        X_feat: Optional[smat.spmatrix] = None,
        ens_method: str = "concat-only",
        **kwargs,
    ) -> smat.csr_matrix:
        """ens_method: concat-only (the ranker alone, default) |
        transformer-only | average | rank_average | sigmoid_average |
        softmax_average | round_robin, which combine the matcher's own
        predictions (its last level must cover every label) with the
        ranker's.  kwargs: beam_size, only_topk, post_processor."""
        if self.concat_model is None:
            return self.text_encoder.predict(corpus, **kwargs)[0]
        only_topk = kwargs.get("only_topk", 20)
        if ens_method == "concat-only":
            tfm_pred, emb = None, self.encode(corpus)
        else:
            tfm_pred, emb = self.text_encoder.predict(corpus, only_topk=only_topk)
            if tfm_pred.shape[1] != self.concat_model.nr_labels:
                raise ValueError(
                    "transformer ensemble requires the matcher's last level to cover "
                    f"the full label space ({tfm_pred.shape[1]} vs {self.concat_model.nr_labels})"
                )
        concat_pred = self.concat_model.predict(TransformerMatcher.concat_features(X_feat, emb), **kwargs)
        if tfm_pred is None:
            return concat_pred
        return TransformerMatcher.ensemble_prediction(tfm_pred, concat_pred, only_topk, ens_method)

    # ------------------------------------------------------------------ persist
    def save(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        param = self.append_meta({"model": type(self).__name__, "has_ranker": self.concat_model is not None})
        with open(os.path.join(folder, "param.json"), "w") as f:
            json.dump(param, f, indent=True)
        self.text_encoder.save(os.path.join(folder, "text_encoder"))
        if self.concat_model is not None:
            self.concat_model.save(os.path.join(folder, "concat_model"))

    @classmethod
    def load(cls, folder: str, device: DeviceLike = "cuda") -> "XTransformer":
        """A folder saved by this package or the JAX package, on ``device``."""
        with open(os.path.join(folder, "param.json")) as f:
            param = json.load(f)
        text_encoder = TransformerMatcher.load(os.path.join(folder, "text_encoder"), device=device)
        concat_model = None
        if param.get("has_ranker"):
            concat_model = XLinearModel.load(os.path.join(folder, "concat_model"), device=device)
        return cls(text_encoder, concat_model)
