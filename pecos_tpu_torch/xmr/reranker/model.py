"""XMR reranker: a text tower and a numeric tower scoring (query, item) pairs
(counterpart of ``pecos_tpu/xmr/reranker/model.py``).

The text tower is a ``transformers`` torch encoder (pooled as the matcher
pools), the numeric tower an MLP with tanh-approximated GELU between its
layers (``jax.nn.gelu``'s default), and the score a linear head on their
concatenation.  Losses: pointwise (squared error of the sigmoid), pairwise
(margin hinge over each group's ordered pairs) and listwise (softmax cross
entropy against the normalized relevance).  Training is AdamW at a constant
rate with global-norm clipping at 1.0, as the JAX package's optax chain.

LoRA: ``lora_rank > 0`` freezes the encoder and wraps each targeted
``nn.Linear`` in a :class:`LoRALinear` that adds scale * (x A) B, with A
(d_in, r) and B (r, d_out) in the JAX package's layout, so its adapters carry
over as they are.  The base weights stay untouched; ``save`` writes the
encoder with the deltas merged in, which is the JAX package's folder.

The numpy draws (head and tower init, LoRA's A, the group shuffles) follow
the JAX package's order, so one seed gives its arrays.
"""

from __future__ import annotations

import copy
import dataclasses as dc
import glob
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

import pecos_tpu_torch
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device
from pecos_tpu_torch.xmc.xtransformer import network
from pecos_tpu_torch.xmc.xtransformer.matcher import TransformerMatcher, clip_by_global_norm_
from pecos_tpu_torch.xmc.xtransformer.module import tokenize_corpus

LOGGER = logging.getLogger(__name__)


def _mlp_init(rng, sizes: Sequence[int]) -> List[Dict[str, np.ndarray]]:
    """He-normal layers {"w": (in, out), "b": (out,)}, drawn as the JAX package draws them."""
    return [
        {
            "w": (rng.standard_normal((sizes[i], sizes[i + 1])) * np.sqrt(2.0 / sizes[i])).astype(np.float32),
            "b": np.zeros(sizes[i + 1], np.float32),
        }
        for i in range(len(sizes) - 1)
    ]


class NumrTower(nn.Module):
    """The numeric tower: Linear layers with tanh-approximated GELU between
    them.  Built from and read back as the JAX package's layer dicts, whose
    "w" is (in, out)."""

    def __init__(self, layers: Sequence[Dict[str, np.ndarray]]):
        super().__init__()
        self.linears = nn.ModuleList()
        for layer in layers:
            w, b = np.asarray(layer["w"], np.float32), np.asarray(layer["b"], np.float32)
            lin = nn.Linear(*w.shape)
            with torch.no_grad():
                lin.weight.copy_(torch.from_numpy(w.T.copy()))
                lin.bias.copy_(torch.from_numpy(b))
            self.linears.append(lin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < len(self.linears) - 1:
                x = F.gelu(x, approximate="tanh")
        return x

    def to_params(self) -> List[Dict[str, np.ndarray]]:
        return [{"w": lin.weight.detach().cpu().numpy().T.copy(), "b": lin.bias.detach().cpu().numpy()}
                for lin in self.linears]


# ---------------------------------------------------------------------------
# LoRA: low-rank deltas on the attention projections, the encoder frozen
# ---------------------------------------------------------------------------


class LoRALinear(nn.Module):
    """``base(x) + scale * (x @ a) @ b`` around a frozen ``nn.Linear``; a is
    (d_in, r) and b (r, d_out), the JAX package's adapter layout."""

    def __init__(self, base: nn.Linear, a: np.ndarray, b: np.ndarray, scale: float):
        super().__init__()
        self.base = base
        dev = base.weight.device
        self.lora_a = nn.Parameter(torch.from_numpy(np.asarray(a, np.float32)).to(dev))
        self.lora_b = nn.Parameter(torch.from_numpy(np.asarray(b, np.float32)).to(dev))
        self.scale = float(scale)

    @property
    def weight(self) -> torch.Tensor:  # the base's, for code that reads a projection's weight
        return self.base.weight

    @property
    def bias(self) -> Optional[torch.Tensor]:
        return self.base.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.base(x) + self.scale * ((x @ self.lora_a) @ self.lora_b)

    def merged(self) -> nn.Linear:
        """A plain Linear whose weight holds the delta: W + scale * (a b)^T."""
        lin = copy.deepcopy(self.base)
        with torch.no_grad():
            lin.weight.add_(self.scale * (self.lora_a @ self.lora_b).T)
        return lin


def _jax_path(module_name: str) -> str:
    """The JAX package's path of a Linear's kernel: ``transformer/layer/0/attention/q_lin/kernel``."""
    return module_name.replace(".", "/") + "/kernel"


def lora_target_paths(encoder: nn.Module, target_substrings: Sequence[str]) -> List[str]:
    """The kernels LoRA adapts, named and sorted as the JAX package names
    them: every ``nn.Linear`` whose path mentions a target."""
    return sorted(
        _jax_path(name) for name, m in encoder.named_modules()
        if isinstance(m, nn.Linear) and any(t in _jax_path(name) for t in target_substrings)
    )


def _module_at(encoder: nn.Module, path: str) -> Tuple[nn.Module, str]:
    names = path[: -len("/kernel")].split("/")
    parent = encoder.get_submodule(".".join(names[:-1])) if len(names) > 1 else encoder
    return parent, names[-1]


def lora_init(encoder: nn.Module, paths: Sequence[str], rank: int, seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """A ~ N(0, 0.02) (d_in, r) and B = 0 (r, d_out) for each path, drawn in
    the given order as the JAX package draws them (the delta starts at 0)."""
    rng = np.random.default_rng(seed)
    adapters = {}
    for p in paths:
        parent, name = _module_at(encoder, p)
        lin = getattr(parent, name)
        adapters[p] = {
            "a": (rng.standard_normal((lin.in_features, rank)) * 0.02).astype(np.float32),
            "b": np.zeros((rank, lin.out_features), np.float32),
        }
    return adapters


def lora_apply(encoder: nn.Module, adapters: Dict[str, Dict[str, np.ndarray]], alpha: float) -> List[LoRALinear]:
    """Wrap each adapted Linear of ``encoder`` in place in a :class:`LoRALinear`
    (scale alpha / r); returns the wrappers."""
    wrappers = []
    for p, ab in adapters.items():
        parent, name = _module_at(encoder, p)
        w = LoRALinear(getattr(parent, name), ab["a"], ab["b"], alpha / max(ab["a"].shape[1], 1))
        setattr(parent, name, w)
        wrappers.append(w)
    return wrappers


def lora_merged(encoder: nn.Module) -> nn.Module:
    """A copy of ``encoder`` with every LoRALinear replaced by its merged Linear."""
    out = copy.deepcopy(encoder)
    for name, m in list(out.named_modules()):
        if isinstance(m, LoRALinear):
            parent, child = _module_at(out, _jax_path(name))
            setattr(parent, child, m.merged())
    return out


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def ranking_loss(logits: torch.Tensor, labels: torch.Tensor, kind: str, margin: float) -> torch.Tensor:
    """The loss of (B, G) logits against (B, G) relevance labels, G candidates
    a query: pointwise, pairwise or listwise."""
    if kind == "pointwise":
        return torch.mean((torch.sigmoid(logits) - labels) ** 2)
    if kind == "pairwise":
        li = logits[:, :, None] - logits[:, None, :]
        mask = (labels[:, :, None] - labels[:, None, :] > 0).to(logits.dtype)
        return (torch.clamp(margin - li, min=0.0) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if kind == "listwise":
        p = labels / torch.clamp(labels.sum(dim=1, keepdim=True), min=1e-6)
        return -torch.mean((p * torch.log_softmax(logits, dim=1)).sum(dim=1))
    raise ValueError(kind)


class TextNumrEncoder(pecos_tpu_torch.BaseClass):
    """Text tower (a torch encoder) + numeric tower + linear score head
    {"w": (H_cat, 1), "b": (1,)}."""

    def __init__(self, encoder, tokenizer, numr_params, head_params, numr_dim: int, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.encoder = encoder.to(self.device).eval()
        self.tokenizer = tokenizer
        self.numr = NumrTower(numr_params).to(self.device) if numr_params else None
        self.head_params = {k: np.asarray(v, np.float32) for k, v in head_params.items()}
        self.numr_dim = numr_dim

    @property
    def numr_params(self):
        return self.numr.to_params() if self.numr is not None else None

    @property
    def hidden_size(self):
        return network.hidden_size(self.encoder.config)

    def scores(self, batch: dict, head: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(n,) scores of a batch of tokenized pairs (+ numeric features)."""
        emb = network.pooled_embedding(
            self.encoder(input_ids=batch["input_ids"], attention_mask=batch["attention_mask"]), batch["attention_mask"]
        )
        if self.numr is not None:
            emb = torch.cat([emb, self.numr(batch["numr"])], dim=1)
        return (emb @ head["w"] + head["b"])[:, 0]


class RankingModel(pecos_tpu_torch.BaseClass):
    @dc.dataclass
    class TrainParams(pecos_tpu_torch.BaseParams):
        model_type: str = "distilbert"
        model_shortcut: str = "distilbert-base-uncased"
        model_config: Optional[dict] = None
        numr_hidden: Tuple[int, ...] = (64,)
        truncate_length: int = 64
        batch_size: int = 16
        learning_rate: float = 5e-5
        weight_decay: float = 0.01
        num_train_epochs: int = 1
        max_steps: int = 0
        loss_fn: str = "pointwise"  # pointwise | pairwise | listwise
        pairwise_margin: float = 0.3
        group_size: int = 4  # candidates per query for pairwise/listwise
        # LoRA: rank 0 fine-tunes the whole encoder; rank > 0 freezes it and
        # trains low-rank deltas on the targeted projections
        lora_rank: int = 0
        lora_alpha: float = 16.0
        lora_targets: Tuple[str, ...] = ("q_lin", "v_lin", "query", "value")
        seed: int = 0

    @dc.dataclass
    class PredParams(pecos_tpu_torch.BaseParams):
        batch_size: int = 64
        truncate_length: int = 64

    def __init__(self, enc: TextNumrEncoder, train_params=None, pred_params=None):
        self.enc = enc
        self.train_params = self.TrainParams.from_dict(train_params)
        self.pred_params = self.PredParams.from_dict(pred_params)
        self.lora: List[LoRALinear] = []  # the adapters of a LoRA train, live in enc.encoder
        self.train_losses: Optional[np.ndarray] = None

    @property
    def device(self):
        return self.enc.device

    # ------------------------------------------------------------------ setup
    @classmethod
    def init_model(cls, train_params: "RankingModel.TrainParams", numr_dim: int, device: DeviceLike = "cuda") -> "RankingModel":
        tp = TransformerMatcher.TrainParams(
            model_type=train_params.model_type, model_shortcut=train_params.model_shortcut,
            model_config=train_params.model_config, seed=train_params.seed,
        )
        encoder, tokenizer = TransformerMatcher.download_model(tp)
        rng = np.random.default_rng(train_params.seed)
        numr_params = _mlp_init(rng, (numr_dim, *train_params.numr_hidden)) if numr_dim > 0 else None
        cat = network.hidden_size(encoder.config) + (train_params.numr_hidden[-1] if numr_dim > 0 else 0)
        head = {"w": (rng.standard_normal((cat, 1)) * 0.02).astype(np.float32), "b": np.zeros(1, np.float32)}
        return cls(TextNumrEncoder(encoder, tokenizer, numr_params, head, numr_dim, device=device), train_params)

    # ------------------------------------------------------------------ train
    @classmethod
    def _trainer(cls, train_params, numr_dim: int, device):
        """The model, its group size and a step function over one batch,
        shared by the in-memory and the parquet-streaming train."""
        self = cls.init_model(train_params, numr_dim, device=device)
        enc = self.enc
        dev = enc.device
        G = train_params.group_size if train_params.loss_fn != "pointwise" else 1
        if train_params.lora_rank > 0:
            paths = lora_target_paths(enc.encoder, train_params.lora_targets)
            if not paths:
                raise ValueError(f"no LoRA target kernels matched {train_params.lora_targets} in the encoder")
            LOGGER.info("LoRA rank %d on %d kernels", train_params.lora_rank, len(paths))
            for p in enc.encoder.parameters():
                p.requires_grad_(False)
            adapters = lora_init(enc.encoder, paths, train_params.lora_rank, seed=train_params.seed)
            self.lora = lora_apply(enc.encoder, adapters, train_params.lora_alpha)
            params = [t for w in self.lora for t in (w.lora_a, w.lora_b)]
        else:
            params = list(enc.encoder.parameters())
        if enc.numr is not None:
            params += list(enc.numr.parameters())
        head = {k: torch.from_numpy(v).to(dev).requires_grad_(True) for k, v in enc.head_params.items()}
        params += [head["w"], head["b"]]
        opt = torch.optim.AdamW(params, lr=train_params.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=train_params.weight_decay)
        kind, margin = train_params.loss_fn, train_params.pairwise_margin

        def step(batch) -> torch.Tensor:
            logits = enc.scores(batch, head)
            bsz = logits.shape[0] // G
            loss = ranking_loss(logits.reshape(bsz, G), batch["labels"].reshape(bsz, G), kind, margin)
            loss.backward()
            clip_by_global_norm_([p.grad for p in params if p.grad is not None], 1.0)
            opt.step()
            opt.zero_grad(set_to_none=True)
            return loss.detach()

        def finish(losses):
            enc.encoder.eval()
            enc.head_params = {k: v.detach().cpu().numpy() for k, v in head.items()}
            self.train_losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
            return self

        enc.encoder.train()
        return self, G, step, finish

    @staticmethod
    def _run_epoch_batches(step, toks, labels, numeric_feats, G: int, B: int, rng, total: int, losses: list, device):
        """One shuffled pass over a tokenized block, whole groups a batch."""
        N = labels.shape[0]
        groups = np.arange(N // G)
        rng.shuffle(groups)
        for s in range(0, len(groups) * G - B + 1, B) if N >= B else [0]:
            gsel = groups[s // G : s // G + B // G]
            idx = (gsel[:, None] * G + np.arange(G)[None, :]).ravel()
            if len(idx) < B:
                idx = np.concatenate([idx, idx[: B - len(idx)]])
            batch = {
                "input_ids": torch.from_numpy(toks["input_ids"][idx].astype(np.int64)).to(device),
                "attention_mask": torch.from_numpy(toks["attention_mask"][idx].astype(np.int64)).to(device),
                "labels": torch.from_numpy(labels[idx]).to(device),
            }
            if numeric_feats is not None:
                batch["numr"] = torch.from_numpy(np.asarray(numeric_feats[idx], np.float32)).to(device)
            losses.append(step(batch))
            if len(losses) % 20 == 0:
                LOGGER.info(f"reranker step {len(losses)}/{total} loss={float(losses[-1]):.5f}")
            if len(losses) >= total:
                break

    @classmethod
    def train(
        cls,
        inputs: Sequence[str],  # B*G flattened "query [SEP] item" texts
        labels: np.ndarray,  # (B*G,) relevance in [0, 1]
        numeric_feats: Optional[np.ndarray] = None,  # (B*G, F)
        train_params=None,
        pred_params=None,
        device: DeviceLike = "cuda",
        **kwargs,
    ) -> "RankingModel":
        """Train on ``device``; kwargs override train_params fields."""
        train_params = cls.TrainParams.from_dict(train_params)
        train_params.override_with_kwargs(kwargs)
        device = resolve_device(device)
        numr_dim = numeric_feats.shape[1] if numeric_feats is not None else 0
        self, G, step, finish = cls._trainer(train_params, numr_dim, device)
        N = len(inputs)
        if N % G:
            raise ValueError(f"inputs length {N} not divisible by group_size {G}")
        toks = tokenize_corpus(self.enc.tokenizer, inputs, train_params.truncate_length)
        labels = np.asarray(labels, np.float32)
        B = max(G, (train_params.batch_size // G) * G)
        total = train_params.max_steps or max(1, N // B) * train_params.num_train_epochs
        rng = np.random.default_rng(train_params.seed)
        losses: list = []
        with torch.random.fork_rng(devices=[device.index] if device.type == "cuda" else []):
            torch.manual_seed(train_params.seed)
            for _epoch in range(max(1, train_params.num_train_epochs)):
                cls._run_epoch_batches(step, toks, labels, numeric_feats, G, B, rng, total, losses, device)
                if len(losses) >= total:
                    break
        return finish(losses)

    @classmethod
    def train_streaming(
        cls,
        shard_paths: Sequence[str],
        query_col: str = "query",
        item_col: str = "item",
        label_col: str = "relevance",
        train_params=None,
        pred_params=None,
        device: DeviceLike = "cuda",
        **kwargs,
    ) -> "RankingModel":
        """Train from parquet shards, one shard tokenized and resident at a
        time.  Each shard's row count must be divisible by group_size, so no
        group straddles two shards."""
        train_params = cls.TrainParams.from_dict(train_params)
        train_params.override_with_kwargs(kwargs)
        device = resolve_device(device)
        self, G, step, finish = cls._trainer(train_params, 0, device)
        B = max(G, (train_params.batch_size // G) * G)
        total = train_params.max_steps or max(1, RankingDataUtils.get_parquet_rows(shard_paths) // B) * train_params.num_train_epochs
        rng = np.random.default_rng(train_params.seed)
        losses: list = []
        with torch.random.fork_rng(devices=[device.index] if device.type == "cuda" else []):
            torch.manual_seed(train_params.seed)
            for _epoch in range(max(1, train_params.num_train_epochs)):
                for df in RankingDataUtils.iter_parquet_shards(shard_paths):
                    inputs, labels = RankingDataUtils.build_pairs(df, query_col=query_col, item_col=item_col, label_col=label_col)
                    if len(inputs) % G:
                        raise ValueError(f"shard rows ({len(inputs)}) not divisible by group_size {G}")
                    toks = tokenize_corpus(self.enc.tokenizer, inputs, train_params.truncate_length)
                    cls._run_epoch_batches(step, toks, labels, None, G, B, rng, total, losses, device)
                    if len(losses) >= total:
                        break
                if len(losses) >= total:
                    break
        return finish(losses)

    # ------------------------------------------------------------------ predict
    def predict(self, inputs: Sequence[str], numeric_feats: Optional[np.ndarray] = None, **kwargs) -> np.ndarray:
        """(n,) float32 scores of "query [SEP] item" texts; kwargs override
        batch_size and truncate_length."""
        pred_params = self.PredParams.from_dict(self.pred_params)
        pred_params.override_with_kwargs(kwargs)
        enc, dev = self.enc, self.enc.device
        toks = tokenize_corpus(enc.tokenizer, list(inputs), pred_params.truncate_length)
        head = {k: torch.from_numpy(v).to(dev) for k, v in enc.head_params.items()}
        B, out = pred_params.batch_size, []
        enc.encoder.eval()
        with torch.no_grad():
            for s in range(0, toks["input_ids"].shape[0], B):
                batch = {k: torch.from_numpy(v[s : s + B].astype(np.int64)).to(dev) for k, v in toks.items()}
                if enc.numr is not None:
                    batch["numr"] = torch.from_numpy(np.asarray(numeric_feats[s : s + B], np.float32)).to(dev)
                out.append(enc.scores(batch, head))
        return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.float32)

    # ------------------------------------------------------------------ persist
    def save(self, save_dir: str):
        """encoder/ (LoRA deltas merged in), tokenizer/, towers.npz and
        param.json: the JAX package's folder."""
        os.makedirs(save_dir, exist_ok=True)
        encoder = lora_merged(self.enc.encoder) if self.lora else self.enc.encoder
        encoder.save_pretrained(os.path.join(save_dir, "encoder"))
        self.enc.tokenizer.save_pretrained(os.path.join(save_dir, "tokenizer"))
        numr = self.enc.numr_params or []
        np.savez(
            os.path.join(save_dir, "towers.npz"), head_w=self.enc.head_params["w"], head_b=self.enc.head_params["b"],
            **{f"numr{i}_{k}": v for i, layer in enumerate(numr) for k, v in layer.items()},
        )
        param = self.append_meta({
            "train_params": self.train_params.to_dict(), "pred_params": self.pred_params.to_dict(),
            "numr_dim": self.enc.numr_dim, "n_numr_layers": len(numr),
        })
        with open(os.path.join(save_dir, "param.json"), "w") as f:
            json.dump(param, f, indent=True)

    @classmethod
    def load(cls, load_dir: str, device: DeviceLike = "cuda") -> "RankingModel":
        """A folder saved by this package or the JAX package, on ``device``."""
        import transformers

        with open(os.path.join(load_dir, "param.json")) as f:
            param = json.load(f)
        strip = lambda d: {k: v for k, v in d.items() if k != "__meta__"}
        train_params = cls.TrainParams.from_dict(strip(param["train_params"]))
        encoder = network.load_encoder(os.path.join(load_dir, "encoder"), train_params.model_type)
        tokenizer = transformers.AutoTokenizer.from_pretrained(os.path.join(load_dir, "tokenizer"))
        with np.load(os.path.join(load_dir, "towers.npz")) as z:
            head = {"w": z["head_w"], "b": z["head_b"]}
            numr = [{"w": z[f"numr{i}_w"], "b": z[f"numr{i}_b"]} for i in range(param["n_numr_layers"])] or None
        enc = TextNumrEncoder(encoder, tokenizer, numr, head, param["numr_dim"], device=device)
        return cls(enc, train_params=train_params, pred_params=strip(param["pred_params"]))


class RankingDataUtils(object):
    """Parquet-sharded (query, item, relevance) data helpers; pandas and
    pyarrow are imported where they are used."""

    @staticmethod
    def load_parquet(paths: Sequence[str]):
        import pandas as pd

        frames = [pd.read_parquet(p) for p in paths]
        return pd.concat(frames, ignore_index=True) if len(frames) > 1 else frames[0]

    @staticmethod
    def build_pairs(df, query_col="query", item_col="item", label_col="relevance", sep=" [SEP] "):
        inputs = (df[query_col].astype(str) + sep + df[item_col].astype(str)).tolist()
        return inputs, df[label_col].to_numpy(dtype=np.float32)

    @staticmethod
    def _expand_paths(paths_or_folder) -> list:
        if isinstance(paths_or_folder, str):
            if os.path.isdir(paths_or_folder):
                return sorted(glob.glob(os.path.join(paths_or_folder, "*.parquet")))
            return [paths_or_folder]
        return list(paths_or_folder)

    @classmethod
    def get_parquet_rows(cls, paths_or_folder) -> int:
        """Total row count from the parquet footers, reading no data."""
        import pyarrow.parquet as pq

        return sum(pq.ParquetFile(p).metadata.num_rows for p in cls._expand_paths(paths_or_folder))

    @classmethod
    def iter_parquet_shards(cls, paths_or_folder, columns=None):
        """One DataFrame per parquet file: one shard resident at a time."""
        import pandas as pd

        for p in cls._expand_paths(paths_or_folder):
            yield pd.read_parquet(p, columns=columns)
