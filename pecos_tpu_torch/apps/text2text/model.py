"""Text2Text: raw text in, ranked output items out.

The port of ``pecos_tpu/apps/text2text/model.py``: a Preprocessor (TF-IDF, on
the host) feeds an ensemble of XLinearModels, one per (label-embedding method,
seed), whose predictions (beam search through K1 on the card) a
``CsrEnsembler`` method combines.  ``CachedWorkspace`` keeps intermediates by
content hash.  The model folder is the JAX package's: ``param.json``,
``output_items.json``, ``preprocessor/`` and ``{i}.model``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
from typing import List, Optional, Sequence

import scipy.sparse as smat

import pecos_tpu_torch
from pecos_tpu_torch.utils import smat_util
from pecos_tpu_torch.utils.featurization.text import Preprocessor
from pecos_tpu_torch.utils.torch_util import DeviceLike
from pecos_tpu_torch.xmc import Indexer, LabelEmbeddingFactory
from pecos_tpu_torch.xmc.xlinear import XLinearModel

LOGGER = logging.getLogger(__name__)


class CachedWorkspace(object):
    """Intermediates pickled in ``folder`` under a key hashed from their inputs
    (no folder: nothing is kept).  Only this program's own files are read back."""

    def __init__(self, folder: Optional[str]):
        self.folder = folder
        if folder:
            os.makedirs(folder, exist_ok=True)

    def get_path(self, name: str, **kwargs) -> Optional[str]:
        if not self.folder:
            return None
        key = hashlib.sha1(json.dumps({k: str(v) for k, v in sorted(kwargs.items())}).encode()).hexdigest()[:16]
        return os.path.join(self.folder, f"{name}_{key}.pkl")

    def load(self, path: Optional[str]):
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        return None

    def dump(self, path: Optional[str], obj) -> None:
        if path:
            with open(path, "wb") as f:
                pickle.dump(obj, f)


class Text2Text(pecos_tpu_torch.BaseClass):
    def __init__(
        self,
        preprocessor: Preprocessor,
        xlinear_models: Sequence[XLinearModel],
        output_items: Sequence[str],
        ens_method: str = "average",
    ):
        self.preprocessor = preprocessor
        self.xlinear_models = list(xlinear_models)
        self.output_items = list(output_items)
        self.ens_method = ens_method

    @property
    def nr_labels(self):
        return len(self.output_items)

    @classmethod
    def train(
        cls,
        input_text_path: str,
        output_item_path: str,
        label_embed_type: Sequence[str] = ("pifa",),
        ensemble_seeds: Sequence[int] = (0,),
        ens_method: str = "average",
        vectorizer_config: Optional[dict] = None,
        indexer_kwargs: Optional[dict] = None,
        xlinear_kwargs: Optional[dict] = None,
        workspace_folder: Optional[str] = None,
        device: DeviceLike = "cuda",
        **kwargs,
    ) -> "Text2Text":
        """Train from an XMC text file (``label_ids\\ttext`` per line) and an
        output-item file (one item per line).  The vectorizer and the label
        embeddings run on the host; each member's clustering and XR-Linear
        train run on ``device``."""
        ws = CachedWorkspace(workspace_folder)
        with open(output_item_path, encoding="utf-8") as f:
            output_items = [line.rstrip("\n") for line in f]
        parsed = Preprocessor.load_data_from_file(input_text_path, label_text_path=output_item_path)
        corpus, Y = parsed["corpus"], parsed["label_matrix"]
        if Y.shape[1] < len(output_items):
            Y = smat.csr_matrix((Y.data, Y.indices, Y.indptr), shape=(Y.shape[0], len(output_items)))

        feat_path = ws.get_path("X_feat", corpus_file=input_text_path, cfg=vectorizer_config)
        cached = ws.load(feat_path)
        if cached is not None:
            preprocessor, X = cached
        else:
            preprocessor = Preprocessor.train(corpus, vectorizer_config=vectorizer_config)
            X = preprocessor.predict(corpus)
            ws.dump(feat_path, (preprocessor, X))

        models: List[XLinearModel] = []
        for method in label_embed_type:
            label_feat = LabelEmbeddingFactory.create(Y, X, method=method)
            for seed in ensemble_seeds:
                LOGGER.info(f"training ensemble member embed={method} seed={seed}")
                chain = Indexer.gen(label_feat, seed=seed, device=device, **(indexer_kwargs or {}))
                models.append(XLinearModel.train(X, Y, C=chain, device=device, **(xlinear_kwargs or {})))
        return cls(preprocessor, models, output_items, ens_method=ens_method)

    def predict(self, corpus: Sequence[str], topk: int = 10, ret_csr: bool = False, **pred_kwargs):
        """Rank the output items for each text: each member keeps its top
        max(topk, 10), the ensemble method combines them and each row keeps
        its top ``topk``.  Returns per text a list of (item, score), or with
        ``ret_csr`` the (texts, items) CSR.  pred_kwargs go to each member's
        predict (beam_size, post_processor, ...)."""
        X = self.preprocessor.predict(list(corpus))
        preds = [m.predict(X, only_topk=max(topk, 10), **pred_kwargs) for m in self.xlinear_models]
        P = preds[0] if len(preds) == 1 else getattr(smat_util.CsrEnsembler, self.ens_method)(*preds)
        P = smat_util.sorted_csr(P.tocsr(), only_topk=topk)
        if ret_csr:
            return P
        return [
            [(self.output_items[j], float(v)) for j, v in zip(P.indices[s:e], P.data[s:e])]
            for s, e in zip(P.indptr[:-1], P.indptr[1:])
        ]

    def save(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        param = self.append_meta(
            {"model": type(self).__name__, "nr_ensembles": len(self.xlinear_models), "ens_method": self.ens_method}
        )
        with open(os.path.join(folder, "param.json"), "w") as f:
            json.dump(param, f, indent=True)
        with open(os.path.join(folder, "output_items.json"), "w") as f:
            json.dump(self.output_items, f)
        self.preprocessor.save(os.path.join(folder, "preprocessor"))
        for i, m in enumerate(self.xlinear_models):
            m.save(os.path.join(folder, f"{i}.model"))

    @classmethod
    def load(cls, folder: str, device: DeviceLike = "cuda") -> "Text2Text":
        """A folder written by either package, its members on ``device``."""
        with open(os.path.join(folder, "param.json")) as f:
            param = json.load(f)
        with open(os.path.join(folder, "output_items.json")) as f:
            output_items = json.load(f)
        preprocessor = Preprocessor.load(os.path.join(folder, "preprocessor"))
        models = [XLinearModel.load(os.path.join(folder, f"{i}.model"), device=device) for i in range(param["nr_ensembles"])]
        return cls(preprocessor, models, output_items, ens_method=param["ens_method"])
