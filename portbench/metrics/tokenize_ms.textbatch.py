"""tokenize_ms.textbatch: host milliseconds in the program's span
``pecos.tokenize`` (``tokenize_corpus``: the WordPiece tokenizer over a
call's texts, padded to the truncate length) a 1,024 texts, the texts the
encoder took (``pecos.encode.texts``).  Over the whole process, set-up calls
included (``program_spans``)."""

from portbench import program_spans

TEXTS = 1024


def read(ctx):
    snap = program_spans.registry()
    span = snap and snap["spans"].get("pecos.tokenize")
    texts = snap and snap["counters"].get("pecos.encode.texts")
    if not span or not texts:
        return None
    return 1e3 * span["s"] * TEXTS / texts
