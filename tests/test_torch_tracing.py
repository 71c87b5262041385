"""The port's spans and counters (``pecos_tpu_torch.utils.profile_util``) and
where the predict path records them: the registry's sums, nesting and
exceptions, ``record_function`` only under a recording profiler, the spans as
``user_annotation`` events of a profiler's trace, and the counters of padded
query slots."""

import json

import numpy as np
import pytest
import scipy.sparse as smat
import torch
from torch.profiler import ProfilerActivity, profile

from pecos_tpu_torch.utils import profile_util
from pecos_tpu_torch.xmc.inference import CompiledHierModel, encode_wire_batch, pad_query_rows, prepare_queries_padded

D = 128
SIZES = [4, 32, 256]
LAYOUTS = ["dense", "plabel", "plabel"]


def make_chain(seed=0, nnz=6):
    """(Ws, Cs) of a tree over SIZES: every node weighs ``nnz`` features and the bias."""
    rng = np.random.default_rng(seed)
    Ws, Cs, n_parents = [], [], 1
    for L in SIZES:
        rows = np.concatenate([np.sort(rng.choice(D, size=(L, nnz)), axis=1), np.full((L, 1), D)], axis=1)
        vals = (rng.standard_normal(rows.shape) * 0.3).astype(np.float32)
        Ws.append(smat.csc_matrix((vals.ravel(), (rows.ravel(), np.repeat(np.arange(L), nnz + 1))), shape=(D + 1, L)))
        Cs.append(smat.csc_matrix((np.ones(L, np.float32), (np.arange(L), np.arange(L) * n_parents // L)),
                                  shape=(L, n_parents)))
        n_parents = L
    return Ws, Cs


@pytest.fixture(scope="module")
def model():
    Ws, Cs = make_chain()
    return CompiledHierModel.from_host_chain(Ws, Cs, 1.0, layouts=LAYOUTS, device="cpu")


@pytest.fixture
def X():
    return smat.random(200, D, density=0.1, format="csr", random_state=1, dtype=np.float32)


@pytest.fixture(autouse=True)
def fresh_registry():
    profile_util.reset()
    yield
    profile_util.reset()


def annotations(prof, tmp_path):
    """The ``user_annotation`` events of a profile's Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]


def inside(child, parent):
    return parent["ts"] <= child["ts"] and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]


def test_spans_accumulate_nest_and_close_on_an_exception():
    for _ in range(3):
        with profile_util.span("outer"):
            with profile_util.span("inner"):
                sum(range(1000))
    with pytest.raises(ValueError):
        with profile_util.span("outer"):
            with profile_util.span("raises"):
                raise ValueError("inside a span")
    profile_util.count("c", 2)
    profile_util.count("c")
    snap = profile_util.snapshot()
    assert {k: v["n"] for k, v in snap["spans"].items()} == {"outer": 4, "inner": 3, "raises": 1}
    assert 0 < snap["spans"]["inner"]["s"] < snap["spans"]["outer"]["s"]
    assert snap["counters"] == {"c": 3}


def test_no_record_function_without_a_profiler(monkeypatch, model, X):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    model.predict(X, batch_size=64)
    assert profile_util.snapshot()["spans"]["pecos.predict"]["n"] == 1


def test_predict_spans_nest_in_a_profiler_trace(model, X, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.predict(X, batch_size=64)
    ev = annotations(prof, tmp_path)
    by_name = {}
    for e in ev:
        by_name.setdefault(e["name"], []).append(e)
    (top,) = by_name["pecos.predict"]
    (fetch,) = by_name["pecos.fetch"]
    assert inside(fetch, top)
    # a batch padded on the device enters pecos.pad twice: the host slice, then the launches
    for name, n in (("pecos.pad", 8), ("pecos.upload", 4), ("pecos.walk", 4)):
        assert len(by_name[name]) == n and all(inside(e, top) for e in by_name[name])
    for d in range(len(SIZES)):
        levels = by_name[f"pecos.level.{d}"]
        assert len(levels) == 4
        assert all(any(inside(e, w) for w in by_name["pecos.walk"]) for e in levels)
    assert {e["tid"] for e in ev} == {top["tid"]}


def test_counters_of_a_call_with_a_short_last_batch(model, X):
    batch = 64
    assert X.shape[0] % batch  # the last batch is short and padded with empty rows
    cap = max(64, 1 << (int(np.diff(X.indptr).max()) - 1).bit_length())
    model.predict(X, batch_size=batch)
    snap = profile_util.snapshot()
    batches = -(-X.shape[0] // batch)
    # each batch uploads its CSR slice: indptr int64, indices int32, data float32
    assert snap["counters"] == {"pecos.batches": batches, "pecos.pad.device": batches,
                                "pecos.upload_bytes": 8 * (X.shape[0] + batches) + 8 * X.nnz,
                                "pecos.query_nnz": X.nnz, "pecos.query_slots": batches * batch * cap}
    assert snap["spans"]["pecos.pad"]["n"] == 2 * batches
    for name in ("pecos.upload", "pecos.walk") + tuple(f"pecos.level.{d}" for d in range(len(SIZES))):
        assert snap["spans"][name]["n"] == batches
    assert snap["spans"]["pecos.predict"]["n"] == snap["spans"]["pecos.fetch"]["n"] == 1


@pytest.mark.parametrize("wire", ["float16", "bfloat16", "uint8"])
def test_counters_of_the_packed_wires(model, X, wire):
    """The packed wires pad on the host and upload one wire buffer a batch:
    no batch padded on the device, the buffers' bytes uploaded, and the same
    nonzeros and slots as the float32 wire."""
    batch = 64
    cap = max(64, 1 << (int(np.diff(X.indptr).max()) - 1).bit_length())
    model.predict(X, batch_size=batch, wire_value_dtype=wire)
    snap = profile_util.snapshot()
    batches = -(-X.shape[0] // batch)
    wire_bytes = sum(
        encode_wire_batch(*pad_query_rows(*prepare_queries_padded(X[s : s + batch], cap=cap), batch, D), D, wire).nbytes
        for s in range(0, X.shape[0], batch)
    )
    assert snap["counters"] == {"pecos.batches": batches, "pecos.pad.device": 0, "pecos.upload_bytes": wire_bytes,
                                "pecos.query_nnz": X.nnz, "pecos.query_slots": batches * batch * cap}
    assert all(snap["spans"][n]["n"] == batches for n in ("pecos.pad", "pecos.upload", "pecos.walk"))


def test_device_padding_counts_every_float32_batch(model):
    """Every sparse float32-wire batch is padded on the device and uploads
    its slice's bytes, whatever its rows: empty ones, a row at the cap."""
    rng = np.random.default_rng(5)
    X = smat.random(300, D, density=0.05, format="csr", random_state=2, dtype=np.float32).tolil()
    X[[3, 4, 10, 299]] = 0
    X[10, rng.choice(D, size=64, replace=False)] = 1.0
    X = X.tocsr()
    model.predict(X, batch_size=128)
    c = profile_util.snapshot()["counters"]
    assert c["pecos.pad.device"] == c["pecos.batches"] == 3
    assert c["pecos.upload_bytes"] == 8 * (300 + 3) + 8 * X.nnz
    assert c["pecos.query_nnz"] == X.nnz and c["pecos.query_slots"] == 3 * 128 * 64


def test_dense_queries_count_batches_and_no_slots(model, X):
    model.predict(X.toarray(), batch_size=64)
    snap = profile_util.snapshot()
    assert snap["counters"] == {"pecos.batches": 4}
    assert all(snap["spans"][n]["n"] == 4 for n in ("pecos.pad", "pecos.upload", "pecos.walk"))


def test_session_adds_nothing_to_the_batch_spans_or_counters(model, X):
    """A session's walk records its levels only: the batch path's spans and
    counters, which the benchmark's readers divide, stay the batch path's."""
    session = model.realtime_session(batch=4, cap=64)
    assert {k: v["n"] for k, v in profile_util.snapshot()["spans"].items()} == {
        f"pecos.level.{d}": 1 for d in range(len(SIZES))
    }  # the warm walk of opening the session
    session.predict(X[:3])
    session.predict(X[3:7])
    snap = profile_util.snapshot()
    assert {k: v["n"] for k, v in snap["spans"].items()} == {f"pecos.level.{d}": 3 for d in range(len(SIZES))}
    assert snap["counters"] == {}


def test_layouts_span_once_per_layer_build():
    Ws, Cs = make_chain(seed=3)
    CompiledHierModel.from_host_chain(Ws, Cs, 1.0, layouts=LAYOUTS, device="cpu")
    CompiledHierModel.from_host_chain(Ws[:1], Cs[:1], 1.0, device="cpu")
    snap = profile_util.snapshot()
    assert snap["spans"]["pecos.layouts"]["n"] == len(SIZES) + 1
    assert snap["counters"] == {}


def test_snapshot_is_a_copy_and_reset_zeroes():
    with profile_util.span("a"):
        pass
    profile_util.count("b", 5)
    snap = profile_util.snapshot()
    snap["spans"]["a"]["n"] = 99
    snap["counters"]["b"] = 99
    again = profile_util.snapshot()
    assert again["spans"]["a"]["n"] == 1 and again["counters"]["b"] == 5
    profile_util.reset()
    assert profile_util.snapshot() == {"spans": {}, "counters": {}}
    assert again["spans"]["a"]["n"] == 1  # an earlier copy outlives reset


@pytest.mark.parametrize("dense", [False, True])
def test_predictions_bit_equal_with_the_profiler_on_and_off(model, X, dense):
    Q = X.toarray() if dense else X
    off = model.predict(Q, batch_size=64)
    with profile(activities=[ProfilerActivity.CPU]):
        on = model.predict(Q, batch_size=64)
    np.testing.assert_array_equal(on.indptr, off.indptr)
    np.testing.assert_array_equal(on.indices, off.indices)
    np.testing.assert_array_equal(on.data, off.data)


# ---------------------------------------------------------------------------
# XR-Transformer's text path: tokenize, encode, fetch, concat
# ---------------------------------------------------------------------------

H = 16  # the encoder's width: the ranker's last H features are the embedding
TEXT_LENGTH = 8


@pytest.fixture(scope="module")
def xtf(tmp_path_factory):
    """An XTransformer over a one-layer BERT of width H and the chain's
    ranker, whose D features are D - H TF-IDF ones and the H embedding
    columns."""
    from pecos_tpu_torch.xmc import HierarchicalMLModel, MLModel
    from pecos_tpu_torch.xmc.xlinear import XLinearModel
    from pecos_tpu_torch.xmc.xtransformer import TransformerMatcher, XTransformer, network

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(40)]
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    encoder = network.random_encoder("bert", dict(hidden_size=H, num_hidden_layers=1, num_attention_heads=2,
                                                  intermediate_size=32, vocab_size=len(vocab),
                                                  max_position_embeddings=16), seed=3)
    matcher = TransformerMatcher(encoder, network.wordpiece_tokenizer(str(path)), network.XMCHead.random(SIZES[-2], H),
                                 pred_params=dict(truncate_length=TEXT_LENGTH), device="cpu")
    Ws, Cs = make_chain(seed=4)
    ranker = XLinearModel(HierarchicalMLModel([MLModel(W, C, bias=1.0, device="cpu") for W, C in zip(Ws, Cs)]))
    return XTransformer(matcher, ranker)


@pytest.fixture
def texts():
    """Texts of 0 to 11 words: those over TEXT_LENGTH - 2 words are truncated."""
    rng = np.random.default_rng(7)
    return [" ".join(f"w{i}" for i in rng.integers(0, 40, n)) for n in rng.integers(0, 12, 30)]


def test_text_spans_and_counters_of_xtransformer_predict(xtf, texts):
    X_feat = smat.random(len(texts), D - H, density=0.1, format="csr", random_state=3, dtype=np.float32)
    tokens = sum(min(len(t.split()) + 2, TEXT_LENGTH) for t in texts)
    for calls in (1, 2):
        xtf.predict(texts, X_feat=X_feat, only_topk=5, beam_size=2)
        snap = profile_util.snapshot()
        for name in ("pecos.tokenize", "pecos.encode", "pecos.embed_fetch", "pecos.concat", "pecos.predict"):
            assert snap["spans"][name]["n"] == calls, name
        c = snap["counters"]
        assert c["pecos.encode.texts"] == calls * len(texts)
        assert c["pecos.encode.tokens"] == calls * tokens
        assert c["pecos.encode.slots"] == calls * len(texts) * TEXT_LENGTH
        assert c["pecos.tokenize.blocks"] == calls  # 30 texts: one block of 256
        assert "pecos.encode.device_us" not in c  # no card: no device time
        assert "pecos.tokenize.hidden" not in c  # nor a forward to hide behind


def test_text_spans_follow_each_other_in_a_profiler_trace(xtf, texts, tmp_path):
    """Each block's ``pecos.tokenize`` lies inside the call's one
    ``pecos.encode``; then the fetch, the concat and the ranker follow."""
    texts = texts * 20  # 600 texts: blocks of 256, 256 and 88
    X_feat = smat.random(len(texts), D - H, density=0.1, format="csr", random_state=3, dtype=np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        xtf.predict(texts, X_feat=X_feat, only_topk=5, beam_size=2)
    ev = {}
    for e in annotations(prof, tmp_path):
        ev.setdefault(e["name"], []).append(e)
    assert len(ev["pecos.tokenize"]) == 3
    assert all(inside(t, ev["pecos.encode"][0]) for t in ev["pecos.tokenize"])
    order = ["pecos.encode", "pecos.embed_fetch", "pecos.concat", "pecos.predict"]
    assert all(len(ev[name]) == 1 for name in order)
    for a, b in zip(order, order[1:]):
        assert ev[a][0]["ts"] + ev[a][0]["dur"] <= ev[b][0]["ts"], (a, b)


def test_encode_batches_counts_every_forward_of_one_call(xtf, texts):
    from pecos_tpu_torch.xmc.xtransformer import network

    matcher = xtf.text_encoder
    toks = {k: v for k, v in matcher.tokenizer(texts, padding="max_length", truncation=True, max_length=TEXT_LENGTH,
                                                return_tensors="np").items() if k in ("input_ids", "attention_mask")}
    network.encode_batches(matcher.encoder, toks, "cpu", batch_size=7)
    snap = profile_util.snapshot()
    assert snap["spans"]["pecos.encode"]["n"] == 1
    assert snap["counters"] == {"pecos.encode.texts": len(texts), "pecos.encode.tokens": int(toks["attention_mask"].sum()),
                                "pecos.encode.slots": len(texts) * TEXT_LENGTH}


@pytest.mark.parametrize("n", [0, 1, 6, 7, 8, 17, 30])
def test_corpus_tokens_tokenize_once_a_block_inside_one_encode(xtf, texts, n):
    from pecos_tpu_torch.xmc.xtransformer import network
    from pecos_tpu_torch.xmc.xtransformer.module import CorpusTokens

    matcher = xtf.text_encoder
    network.encode_batches(matcher.encoder, CorpusTokens(matcher.tokenizer, texts[:n], TEXT_LENGTH), "cpu", batch_size=7)
    snap = profile_util.snapshot()
    blocks = -(-n // 7)
    assert snap["spans"]["pecos.encode"]["n"] == 1
    assert snap["spans"].get("pecos.tokenize", {"n": 0})["n"] == blocks
    assert snap["counters"].get("pecos.tokenize.blocks", 0) == blocks
    assert "pecos.tokenize.hidden" not in snap["counters"]


class FakeEvent:
    """A CUDA event's timing surface: ``record`` stamps a clock that moves
    1.5 ms a record; ``query`` says whether the card has reached it."""

    made = []
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t, self.done = None, False
        FakeEvent.made.append(self)

    def record(self, stream=None):
        FakeEvent.clock += 1.5
        self.t = FakeEvent.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t - self.t


def test_device_span_settles_only_events_the_card_has_reached(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    FakeEvent.made.clear()
    with profile_util.device_span("dev_us", torch.device("cuda", 0)):
        pass
    start, end = FakeEvent.made
    start.done = True
    profile_util.settle()
    assert profile_util.snapshot()["counters"] == {}  # the end not reached: nothing read, nothing waited for
    end.done = True
    profile_util.settle()
    profile_util.settle()
    assert profile_util.snapshot()["counters"] == {"dev_us": 1500}


@pytest.mark.parametrize("done", [set(), {0}, {1, 3}, {0, 1, 2, 3}])
def test_one_device_span_a_forward_and_hidden_blocks_where_the_card_is_behind(xtf, texts, monkeypatch, done):
    """A corpus of five blocks on a card of fake events: one event pair a
    forward, and block j + 1 counts as hidden exactly when forward j's end
    event is not done when its tokenizing ends."""
    from pecos_tpu_torch.xmc.xtransformer import network
    from pecos_tpu_torch.xmc.xtransformer.module import CorpusTokens

    class OnCard(profile_util.device_span):  # the events of a card, the forward on the CPU
        def __init__(self, name, device):
            super().__init__(name, torch.device("cuda", 0))

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(profile_util, "device_span", OnCard)
    FakeEvent.made.clear()
    matcher = xtf.text_encoder

    def tokenizer(*args, **kwargs):  # forward j has ended by block j + 1's end where j is in ``done``
        j = len(FakeEvent.made) // 2 - 1
        if j in done:
            FakeEvent.made[2 * j + 1].done = True
        return matcher.tokenizer(*args, **kwargs)

    network.encode_batches(matcher.encoder, CorpusTokens(tokenizer, texts, TEXT_LENGTH), "cpu", batch_size=7)
    assert len(FakeEvent.made) == 2 * 5
    c = profile_util.snapshot()["counters"]
    assert c["pecos.tokenize.blocks"] == 5
    assert c.get("pecos.tokenize.hidden", 0) == 4 - len(done)  # the first block is never hidden
    for e in FakeEvent.made:
        e.done = True
    profile_util.settle()
    assert profile_util.snapshot()["counters"]["pecos.encode.device_us"] == 5 * 1500


def test_device_span_records_nothing_off_the_card():
    with profile_util.device_span("dev_us", torch.device("cpu")):
        pass
    profile_util.settle()
    assert profile_util.snapshot() == {"spans": {}, "counters": {}}


# ---- K1's pass pair: moved into pecos.k1.passes / .chunks after the fetch ----


def test_predict_moves_k1_pass_counts_after_the_fetch(model, X, monkeypatch):
    """Where K1's launches left a pass pair (on a card), each call moves what
    it holds into ``pecos.k1.passes`` and ``pecos.k1.chunks`` once, after its
    fetch; the benchmark's ``k1_pass_share.batch`` reads their share."""
    from pecos_tpu_torch.xmc import inference
    from portbench import harness

    order, fetch = [], inference._fetch_topk
    monkeypatch.setattr(inference, "_fetch_topk", lambda *a: order.append("fetch") or fetch(*a))

    def take(device):
        order.append("take")
        assert device == model.device
        return (3, 16)

    monkeypatch.setattr(inference, "take_pass_counts", take)
    model.predict(X, batch_size=64)
    model.predict(X[:50], batch_size=64)
    assert order == ["fetch", "take"] * 2
    counters = profile_util.snapshot()["counters"]
    assert (counters["pecos.k1.passes"], counters["pecos.k1.chunks"]) == (6, 32)
    assert harness.metric_reader("k1_pass_share.batch")({}) == pytest.approx(100.0 * 6 / 32)


def test_predict_on_the_cpu_counts_no_k1_passes(model, X):
    """The plain K1 counts nothing, so a CPU predict adds no pass counters and
    the share reads None, as on a program without them."""
    from portbench import harness

    model.predict(X, batch_size=64)
    assert not any(k.startswith("pecos.k1.") for k in profile_util.snapshot()["counters"])
    assert harness.metric_reader("k1_pass_share.batch")({}) is None


@pytest.mark.parametrize(
    "counters, share",
    [
        ({}, None),
        ({"pecos.k1.passes": 5}, None),
        ({"pecos.k1.passes": 0, "pecos.k1.chunks": 0}, None),
        ({"pecos.k1.passes": 1308, "pecos.k1.chunks": 8000}, 16.35),
        ({"pecos.k1.passes": 8, "pecos.k1.chunks": 8}, 100.0),
    ],
)
def test_k1_pass_share_reader(counters, share):
    """100 x passes / chunks from the registry, None where either counter is
    missing or no chunk was counted."""
    from portbench import harness

    for name, n in counters.items():
        profile_util.count(name, n)
    got = harness.metric_reader("k1_pass_share.batch")({})
    assert got == (None if share is None else pytest.approx(share))


def test_k1_pass_share_reads_none_without_a_registry(monkeypatch):
    """A program whose profile_util has no registry (before it had one)."""
    from portbench import harness

    monkeypatch.delattr(profile_util, "snapshot")
    assert harness.metric_reader("k1_pass_share.batch")({}) is None


# ---- the sparse-expert encoder: pecos.moe spans and counters, and their readers ----

MOE = dict(
    hidden_size=H, num_hidden_layers=3, first_k_dense_replace=1, intermediate_size=24, moe_intermediate_size=8,
    n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1, kv_lora_rank=8, qk_rope_head_dim=4,
    qk_nope_head_dim=4, v_head_dim=4, num_attention_heads=2, num_key_value_heads=2, q_lora_rank=None, n_group=1,
    topk_group=1, routed_scaling_factor=2.446, norm_topk_prob=True, rms_norm_eps=1e-5, rope_theta=50000,
    vocab_size=45, max_position_embeddings=16, initializer_range=0.02,
)


@pytest.fixture(scope="module")
def xtf_moe(xtf):
    """``xtf`` with a deepseek_v3 encoder of width H (two expert layers) in place of its BERT."""
    from pecos_tpu_torch.xmc.xtransformer import TransformerMatcher, XTransformer, network

    m = xtf.text_encoder
    matcher = TransformerMatcher(network.random_encoder("deepseek_v3", MOE, seed=4), m.tokenizer, m.head,
                                 pred_params=dict(truncate_length=TEXT_LENGTH), device="cpu")
    return XTransformer(matcher, xtf.concat_model)


def test_moe_spans_and_counters_of_a_predict_move_after_the_fetch(xtf_moe, texts, monkeypatch):
    """A span and a layer count an expert layer's forward; the pairs and the
    busiest expert's load, kept on the device, reach the registry once a
    call, after the embeddings' fetch."""
    from pecos_tpu_torch.xmc.xtransformer import moe

    moe.take_counts("cpu")  # what other tests' forwards left
    profile_util.reset()
    order, settle, take = [], profile_util.settle, moe.take_counts
    monkeypatch.setattr(profile_util, "settle", lambda: order.append("fetch") or settle())
    monkeypatch.setattr(moe, "take_counts", lambda device: order.append("take") or take(device))
    X_feat = smat.random(len(texts), D - H, density=0.1, format="csr", random_state=3, dtype=np.float32)
    tokens = sum(min(len(t.split()) + 2, TEXT_LENGTH) for t in texts)
    for calls in (1, 2):
        xtf_moe.predict(texts, X_feat=X_feat, only_topk=5, beam_size=2)
        snap = profile_util.snapshot()
        assert snap["spans"]["pecos.moe"]["n"] == calls * 2  # one forward of two expert layers a call
        c = snap["counters"]
        assert c["pecos.moe.layers"] == calls * 2
        assert c["pecos.moe.pairs"] == calls * 2 * MOE["num_experts_per_tok"] * tokens
        assert c["pecos.moe.pairs"] / 8 <= c["pecos.moe.max_load"] <= c["pecos.moe.pairs"]
    assert order == ["fetch", "take"] * 2


def reader(name):
    from portbench import harness

    return harness.metric_reader(name)


def moe_ctx(times, calls=4, seconds=0.004, wall=2.0, predict=0.5):
    return {"trace": {"kernels": [("void (anonymous namespace)::grouped_gemm_kernel(CUtensorMap_st)", t) for t in times]
                      + [("gemm_other", 1.0)], "wall_s": wall, "busy_s": 1.5},
            "work": {"moe": {"calls": calls, "seconds": seconds, "experts": 64}, "predict": {"seconds": predict}}}


def test_expert_roofline_reader():
    read = reader("expert_roofline.textbatch")
    assert read(moe_ctx([0.002] * 4)) == pytest.approx(50.0)  # 4 ms of bound in 8 ms of kernel
    assert read(moe_ctx([])) is None  # no such kernel in the trace
    assert read({"trace": moe_ctx([0.002])["trace"], "work": {"predict": {}}}) is None  # no expert layers
    assert read({"trace": None, "work": None}) is None
    with pytest.raises(ValueError, match="launches"):
        read(moe_ctx([0.002] * 3))
    with pytest.raises(RuntimeError, match="over 100%"):
        read(moe_ctx([0.0009] * 4))


def test_expert_load_reader():
    read = reader("expert_load.textbatch")
    ctx = moe_ctx([])
    assert read(ctx) is None  # no counters
    profile_util.count("pecos.moe.pairs", 6400)
    assert read(ctx) is None
    profile_util.count("pecos.moe.max_load", 150)
    assert read(ctx) == pytest.approx(150.0)  # 150 against a mean of 6,400 / 64
    assert read({"work": None}) is None


def test_moe_mfu_reader():
    read = reader("moe_mfu.textbatch")
    assert read(moe_ctx([])) == pytest.approx(25.0)
    assert read({"trace": moe_ctx([])["trace"], "work": {"predict": {"seconds": 0.5}}}) is None
    with pytest.raises(RuntimeError, match="over 100%"):
        read(moe_ctx([], wall=0.4))
