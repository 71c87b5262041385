"""pad_share.batch: percent of the query slots of the padded block that K1
reads (built on the card on the float32 wire, on the host on the others)
that are padding: the real nonzeros of each sparse batch
(``pecos.query_nnz``) against its rows, pad rows included, times the call's
cap (``pecos.query_slots``).  The cap is the call's longest row rounded up
to a power of two, so this is set by the pool and the seed.  Over the whole
process, set-up batches included (``program_spans``)."""

from portbench import program_spans


def read(ctx):
    return program_spans.padded_share()
