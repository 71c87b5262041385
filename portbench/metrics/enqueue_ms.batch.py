"""enqueue_ms.batch: host milliseconds a batch in the program's span
``pecos.walk``, the beam walk as the host enqueues it: ``predict_padded`` and
``chain_predict``, every level's launches.  Over the whole process, set-up
batches included (``program_spans``)."""

from portbench import program_spans


def read(ctx):
    return program_spans.ms_per_batch("pecos.walk")
