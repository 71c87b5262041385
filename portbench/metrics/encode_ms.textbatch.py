"""encode_ms.textbatch: host milliseconds in the program's span
``pecos.encode`` (``encode_batches``: each forward's token upload and its
launches, 256 texts a forward) a 1,024 texts (``pecos.encode.texts``).  Each
upload waits for the card to finish the forward before it, so this is about
the encoder's device time, less the last forward's.  Over the whole
process, set-up calls included (``program_spans``)."""

from portbench import program_spans

TEXTS = 1024


def read(ctx):
    snap = program_spans.registry()
    span = snap and snap["spans"].get("pecos.encode")
    texts = snap and snap["counters"].get("pecos.encode.texts")
    if not span or not texts:
        return None
    return 1e3 * span["s"] * TEXTS / texts
