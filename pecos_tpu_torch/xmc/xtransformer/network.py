"""Text encoders and the XMC label-embedding head (counterpart of
``pecos_tpu/xmc/xtransformer/network.py``).

The five encoder families are ``transformers``' torch models.  The head is a
pair of arrays (W: (L+1, H), b: (L+1,)) whose row L is the padding label, and
a batch's logits over its padded active labels are one gather and one
einsum.  ``transformers`` is imported inside the functions that need it.

Weights move between the packages through :func:`encoder_state_from_flax`
(a Flax params tree as a torch state dict) and :func:`read_flax_msgpack`,
this module's own reader of Flax's ``flax_model.msgpack``: the GPU machine has
neither ``flax`` nor a ``transformers`` that reads Flax files.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

from pecos_tpu_torch.utils import profile_util
from pecos_tpu_torch.utils.torch_util import DeviceLike, resolve_device

# model, config, then the tokenizer class names in order of preference: the
# fast names are aliases in transformers 5, the only names in 4.x.  A model
# named by a dotted path is the port's own class (config from transformers)
ENCODER_CLASSES: Dict[str, Dict[str, object]] = {
    "bert": dict(config="BertConfig", model="BertModel", tokenizer=("BertTokenizerFast", "BertTokenizer")),
    "roberta": dict(config="RobertaConfig", model="RobertaModel", tokenizer=("RobertaTokenizerFast", "RobertaTokenizer")),
    "distilbert": dict(
        config="DistilBertConfig", model="DistilBertModel", tokenizer=("DistilBertTokenizerFast", "DistilBertTokenizer")
    ),
    "xlm-roberta": dict(
        config="XLMRobertaConfig", model="XLMRobertaModel", tokenizer=("XLMRobertaTokenizerFast", "XLMRobertaTokenizer")
    ),
    "xlnet": dict(config="XLNetConfig", model="XLNetModel", tokenizer=("XLNetTokenizerFast", "XLNetTokenizer")),
    # Moonlight-16B-A3B's architecture: latent attention and sparse experts
    # (moe_encoder.py), predict-only; its vocabulary is a WordPiece vocab.txt
    # here, [CLS] and [SEP] standing for BOS and EOS
    "deepseek_v3": dict(
        config="DeepseekV3Config", model="pecos_tpu_torch.xmc.xtransformer.moe_encoder.DeepseekV3Encoder",
        tokenizer=("BertTokenizerFast", "BertTokenizer"),
    ),
}

# families whose vocabulary is a WordPiece vocab.txt (model_config's vocab_file)
_WORDPIECE = ("bert", "distilbert", "deepseek_v3")
_SPECIALS = dict(unk_token="[UNK]", sep_token="[SEP]", pad_token="[PAD]", cls_token="[CLS]", mask_token="[MASK]")


def resolve_encoder(model_type: str):
    """(config class, torch model class, tokenizer class) of a family, as the
    installed ``transformers`` exports them."""
    import transformers

    if model_type not in ENCODER_CLASSES:
        raise ValueError(f"unsupported encoder type {model_type!r}; supported: {sorted(ENCODER_CLASSES)}")
    spec = ENCODER_CLASSES[model_type]
    tokenizer_cls = next((getattr(transformers, n) for n in spec["tokenizer"] if hasattr(transformers, n)), None)
    if tokenizer_cls is None:
        raise ImportError(f"transformers {transformers.__version__} exports none of {spec['tokenizer']}")
    module, _, name = spec["model"].rpartition(".")
    model_cls = getattr(importlib.import_module(module) if module else transformers, name)
    return getattr(transformers, spec["config"]), model_cls, tokenizer_cls


def check_pretrained(model_cls, what: str) -> None:
    """Raise NotImplementedError for a family of the port's own that has no
    ``from_pretrained`` (``deepseek_v3``): it is predict-only, with random
    weights from :func:`random_encoder`; ``what`` names the caller."""
    if not hasattr(model_cls, "from_pretrained"):
        raise NotImplementedError(
            f"{what}: {model_cls.__name__} is predict-only in this package: no loader of published checkpoints, "
            f"no save and no training (its grouped GEMM has no backward); draw it with network.random_encoder"
        )


def hidden_size(config) -> int:
    return config.dim if hasattr(config, "dim") else (config.d_model if hasattr(config, "d_model") else config.hidden_size)


def wordpiece_tokenizer(vocab_file: str):
    """A fast BERT tokenizer over a WordPiece ``vocab.txt`` (lower-cased,
    ``[CLS] text [SEP]``), built with the ``tokenizers`` library, which gives
    the ids ``DistilBertTokenizerFast(vocab_file=...)`` gives under
    transformers 4.x.  Built this way because transformers 5's tokenizer
    classes take no ``vocab_file`` and give every word ``[UNK]``."""
    import transformers
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors

    with open(vocab_file, encoding="utf-8") as f:
        vocab = {}
        for line in f:
            vocab.setdefault(line.rstrip("\n"), len(vocab))
    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]", max_input_chars_per_word=100))
    tok.normalizer = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=True, strip_accents=None, lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])],
    )
    tok.decoder = decoders.WordPiece(prefix="##")
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, model_input_names=["input_ids", "attention_mask"], **_SPECIALS
    )


def random_encoder(model_type: str, model_config: dict, seed: int = 0, device: Optional[DeviceLike] = None,
                   dtype: Optional[torch.dtype] = None):
    """A random-init encoder of ``model_config``'s widths.  A family of the
    port's own (``from_seed``) is drawn on ``device`` (default the CPU) and
    rounded to ``dtype`` (default float32), each tensor from its own seed.
    The ``transformers`` families are drawn on the CPU in float32 from
    ``seed`` (torch's generator, forked so the caller's state is untouched),
    so one seed gives one model on every machine; they take no ``device`` or
    ``dtype``.  ``vocab_file`` is the tokenizer's and is not passed to the
    config."""
    config_cls, model_cls, _ = resolve_encoder(model_type)
    cfg = config_cls(**{k: v for k, v in model_config.items() if k != "vocab_file"})
    if hasattr(model_cls, "from_seed"):
        return model_cls.from_seed(cfg, seed, device=resolve_device(device or "cpu"), dtype=dtype or torch.float32)
    if device is not None or dtype is not None:
        raise ValueError(f"{model_type!r} is drawn on the CPU in float32; it takes no device or dtype")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return model_cls(cfg).eval()


# ---------------------------------------------------------------------------
# Flax params -> torch state dict
# ---------------------------------------------------------------------------


def encoder_state_from_flax(params, model_type: str) -> Dict[str, torch.Tensor]:
    """The torch state dict of a Flax params tree (nested dicts of arrays) of
    the same family: the path is joined by ``.``; ``kernel`` becomes
    ``weight``, transposed when it is 2-D (a dense layer); ``embedding`` and
    ``scale`` become ``weight``.  Other leaves (XLNet's 3-D attention
    projections, its biases and ``mask_emb``) keep name and layout, since the
    JAX package's Flax XLNet mirrors torch's."""
    if model_type not in ENCODER_CLASSES:
        raise ValueError(f"unsupported encoder type {model_type!r}; supported: {sorted(ENCODER_CLASSES)}")
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
            return
        a = np.asarray(node)
        name = path[-1]
        if name == "kernel":
            name, a = "weight", (a.T if a.ndim == 2 else a)
        elif name in ("embedding", "scale"):
            name = "weight"
        out[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    walk(params, ())
    return out


def load_state_strict(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """``model.load_state_dict(state)`` that raises on any parameter the state
    lacks or any key the model lacks, and leaves non-persistent buffers."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    params = {n for n, _ in model.named_parameters()}
    if unexpected or params & set(missing):
        raise ValueError(f"state does not fit {type(model).__name__}: missing {sorted(params & set(missing))}, "
                         f"unexpected {sorted(unexpected)}")


# ---------------------------------------------------------------------------
# Flax's msgpack checkpoint format, read without flax or msgpack
# ---------------------------------------------------------------------------


class _Reader:
    """A msgpack decoder for the types Flax writes: maps, arrays, strings,
    binaries, integers, floats, nil, booleans and ext types (1: an ndarray,
    3: a numpy scalar, each as a packed (shape, dtype name, bytes))."""

    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return bytes(self.take(t & 0x1F)).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"), 0xD9: ("B", "str"), 0xDA: ("H", "str"),
                 0xDB: ("I", "str"), 0xDC: ("H", "array"), 0xDD: ("I", "array"), 0xDE: ("H", "map"), 0xDF: ("I", "map")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode("utf-8")
            return [self.read() for _ in range(n)] if kind == "array" else self.map(n)
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in numbers:
            return self.unpack(numbers[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext or t in (0xC7, 0xC8, 0xC9):
            n = fixext[t] if t in fixext else self.unpack({0xC7: "B", 0xC8: "H", 0xC9: "I"}[t])
            code = self.unpack("b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ext(code: int, data: bytes):
    if code not in (1, 3):
        raise ValueError(f"msgpack: unsupported ext type {code}")
    shape, dtype, raw = _Reader(data).read()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":  # the upper half of a float32
        arr = (np.frombuffer(raw, np.uint16).astype(np.uint32) << 16).view(np.float32)
    else:
        arr = np.frombuffer(raw, dtype=np.dtype(dtype))
    arr = arr.reshape(shape)
    return arr[()] if code == 3 else arr


def _unchunk(node):
    """Flax's chunked leaves (arrays above 2**30 bytes) joined again."""
    if not isinstance(node, dict):
        return node
    if node.get("__msgpack_chunked_array__"):
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def read_flax_msgpack(path: str) -> dict:
    """The params tree of a ``flax_model.msgpack`` (``flax.serialization``'s
    format), as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{path}: {len(r.buf) - r.pos} bytes after the params")
    return _unchunk(tree)


_TORCH_WEIGHTS = ("model.safetensors", "model.safetensors.index.json", "pytorch_model.bin", "pytorch_model.bin.index.json")


def load_encoder(folder: str, model_type: str):
    """An encoder folder as a torch model: torch weights (this package's
    ``save_pretrained``, or any torch checkpoint) through ``from_pretrained``,
    or the JAX package's ``flax_model.msgpack`` through
    :func:`read_flax_msgpack` and :func:`encoder_state_from_flax`."""
    config_cls, model_cls, _ = resolve_encoder(model_type)
    check_pretrained(model_cls, f"load_encoder({folder!r})")
    if any(os.path.exists(os.path.join(folder, n)) for n in _TORCH_WEIGHTS):
        return model_cls.from_pretrained(folder).eval()
    flax_path = os.path.join(folder, "flax_model.msgpack")
    if not os.path.exists(flax_path):
        raise FileNotFoundError(f"{folder}: no torch weights ({', '.join(_TORCH_WEIGHTS)}) and no flax_model.msgpack")
    model = model_cls(config_cls.from_pretrained(folder))
    load_state_strict(model, encoder_state_from_flax(read_flax_msgpack(flax_path), model_type))
    return model.eval()


# ---------------------------------------------------------------------------
# the label-embedding head and the loss
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class XMCHead:
    """Label-embedding head; index nr_labels is the padding label (zero row)."""

    W: np.ndarray  # (L+1, H) float32
    b: np.ndarray  # (L+1,) float32

    @classmethod
    def random(cls, nr_labels: int, hidden: int, seed: int = 0) -> "XMCHead":
        rng = np.random.default_rng(seed)
        W = (rng.standard_normal((nr_labels + 1, hidden)) * 0.02).astype(np.float32)
        W[-1] = 0.0
        return cls(W=W, b=np.zeros(nr_labels + 1, np.float32))

    @classmethod
    def inherit(cls, parent: "XMCHead", C, seed: int = 0) -> "XMCHead":
        """Each child label starts at its parent cluster's row (C: labels x
        clusters, one cluster a label)."""
        parents = C.tocsr().indices
        W = np.vstack([parent.W[parents], np.zeros((1, parent.W.shape[1]), np.float32)])
        b = np.concatenate([parent.b[parents], [0.0]]).astype(np.float32)
        return cls(W=W, b=b)

    @classmethod
    def from_linear(cls, W_linear: np.ndarray, seed: int = 0) -> "XMCHead":
        """From a linear model trained on embeddings: W_linear is (H + 1, L),
        its last row the bias."""
        H = W_linear.shape[0] - 1
        W = np.vstack([W_linear[:H].T, np.zeros((1, H), np.float32)]).astype(np.float32)
        b = np.concatenate([W_linear[H], [0.0]]).astype(np.float32)
        return cls(W=W, b=b)

    @property
    def nr_labels(self) -> int:
        return self.W.shape[0] - 1


def head_logits(W: torch.Tensor, b: torch.Tensor, emb: torch.Tensor, label_ids: torch.Tensor) -> torch.Tensor:
    """logits[i, k] = emb_i . W[label_ids[i, k]] + b[label_ids[i, k]]."""
    return torch.einsum("bkh,bh->bk", W[label_ids], emb) + b[label_ids]


def squared_hinge_loss(logits: torch.Tensor, targets: torch.Tensor, cost: torch.Tensor, denom: Optional[float] = None) -> torch.Tensor:
    """Cost-weighted squared hinge, summed and divided by the count of real
    (cost > 0) entries.  ``denom`` replaces that count: a batch split over
    devices divides each part by the whole batch's, so the parts' losses and
    gradients add up to the whole batch's."""
    margin = torch.clamp(1.0 - targets * logits, min=0.0)
    if denom is None:
        denom = torch.clamp((cost > 0).sum(), min=1).to(logits.dtype)
    return (cost * margin * margin).sum() / denom


def pooled_embedding(encoder_outputs, attention_mask: torch.Tensor) -> torch.Tensor:
    """The pooler's output where the model has a pooler (BERT, RoBERTa,
    XLM-R), else the mean of the last hidden state over unmasked tokens, in
    float32 (a bfloat16 model's too)."""
    pooled = getattr(encoder_outputs, "pooler_output", None)
    if pooled is not None:
        return pooled
    h = encoder_outputs.last_hidden_state.float()
    m = attention_mask[..., None].to(h.dtype)
    return (h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host int array as int64 on ``device``.  To a CUDA device it goes
    from pinned memory and does not wait for the card; the caching host
    allocator records the copy and reuses that memory only once it is done."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def encode_batches(encoder, toks, device: DeviceLike, batch_size: int = 256) -> torch.Tensor:
    """Pooled embeddings (N, H) of text on ``device`` (eval mode, no
    gradient), ``batch_size`` texts a forward.  ``toks`` is either the dict
    of tokenized arrays, whose blocks are sliced, or a
    ``module.CorpusTokens``, whose blocks are tokenized here: each block
    after the forward before it has been enqueued, so the host tokenizes
    while the card encodes.  On a CUDA device each block's tokens go up from
    pinned memory without waiting for the forward before it.

    Records span ``pecos.encode`` over the call; the card's time of each
    forward, its upload included, in ``pecos.encode.device_us`` (read by
    ``profile_util.settle()`` after the fetch); counters
    ``pecos.encode.texts``, ``.tokens`` (unmasked) and ``.slots`` (texts x
    the padded length).  Of a ``CorpusTokens``, also
    ``pecos.tokenize.blocks``, and ``pecos.tokenize.hidden``: the blocks
    whose tokenizing ended before the card had finished the forward before
    them (the event is asked, never waited for)."""
    device = resolve_device(device)
    sliced = isinstance(toks, dict)
    out, forward = [], None
    training = encoder.training
    encoder.eval()
    with torch.no_grad(), profile_util.span("pecos.encode"):
        for s in range(0, toks["input_ids"].shape[0] if sliced else len(toks), batch_size):
            if sliced:
                ids, am = toks["input_ids"][s : s + batch_size], toks["attention_mask"][s : s + batch_size]
            else:
                block = toks.block(s, s + batch_size)
                ids, am = block["input_ids"], block["attention_mask"]
                profile_util.count("pecos.tokenize.blocks")
                if forward is not None and forward.end is not None and not forward.end.query():
                    profile_util.count("pecos.tokenize.hidden")
            profile_util.count("pecos.encode.texts", ids.shape[0])
            profile_util.count("pecos.encode.tokens", int(am.sum()))
            profile_util.count("pecos.encode.slots", ids.size)
            with profile_util.device_span("pecos.encode.device_us", device) as forward:
                ii, mm = (_upload(a, device) for a in (ids, am))
                out.append(pooled_embedding(encoder(input_ids=ii, attention_mask=mm), mm))
    encoder.train(training)
    H = hidden_size(encoder.config)
    return torch.cat(out) if out else torch.zeros((0, H), device=device)
