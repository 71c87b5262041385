"""upload_ms.batch: host milliseconds a batch in the program's span
``pecos.upload``, its upload: the pinning copy and the non-blocking copies to
the card (or the wire's encode and upload).  Over the whole process, set-up
batches included (``program_spans``)."""

from portbench import program_spans


def read(ctx):
    return program_spans.ms_per_batch("pecos.upload")
