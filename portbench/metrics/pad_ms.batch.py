"""pad_ms.batch: host milliseconds a batch in the program's span ``pecos.pad``,
its padding: the CSR slice of the batch, ``prepare_queries_padded`` and
``pad_query_rows``.  Over the whole process, set-up batches included
(``program_spans``)."""

from portbench import program_spans


def read(ctx):
    return program_spans.ms_per_batch("pecos.pad")
