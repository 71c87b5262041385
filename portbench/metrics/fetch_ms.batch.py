"""fetch_ms.batch: host milliseconds a batch in the program's span
``pecos.fetch``, the call's fetch: one concatenation, the copy to the host
(which waits for the card) and the top-k CSR.  Over the whole process, set-up
batches included (``program_spans``)."""

from portbench import program_spans


def read(ctx):
    return program_spans.ms_per_batch("pecos.fetch")
