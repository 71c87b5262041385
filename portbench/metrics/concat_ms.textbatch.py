"""concat_ms.textbatch: host milliseconds in the program's span
``pecos.concat`` (``TransformerMatcher.concat_features``: the embeddings
scaled to unit norm and appended to the TF-IDF rows as dense columns, a new
CSR matrix) a 1,024 texts (``pecos.encode.texts``).  Over the whole process,
set-up calls included (``program_spans``)."""

from portbench import program_spans

TEXTS = 1024


def read(ctx):
    snap = program_spans.registry()
    span = snap and snap["spans"].get("pecos.concat")
    texts = snap and snap["counters"].get("pecos.encode.texts")
    if not span or not texts:
        return None
    return 1e3 * span["s"] * TEXTS / texts
