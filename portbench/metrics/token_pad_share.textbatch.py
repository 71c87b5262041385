"""token_pad_share.textbatch: percent of the token slots the encoder computes
that are padding: 100 x (1 - ``pecos.encode.tokens`` / ``pecos.encode.slots``),
the tokens of the attention masks against texts x the truncate length.  Set
by the pool's text lengths.  Over the whole process, set-up calls included
(``program_spans``)."""

from portbench import program_spans


def read(ctx):
    snap = program_spans.registry()
    slots = snap and snap["counters"].get("pecos.encode.slots")
    if not slots:
        return None
    return 100.0 * (1.0 - snap["counters"].get("pecos.encode.tokens", 0) / slots)
