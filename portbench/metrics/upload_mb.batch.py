"""upload_mb.batch: query megabytes (10^6 bytes) the program copied to the
card a batch: ``pecos.upload_bytes`` / ``pecos.batches``, the CSR slice of a
batch padded on the card, the padded block or wire buffer of one padded on
the host.  None where the program keeps no such counter.  Over the whole
process, set-up batches included (``program_spans``)."""

from portbench import program_spans


def read(ctx):
    snap = program_spans.registry()
    counters = snap["counters"] if snap else {}
    if "pecos.upload_bytes" not in counters or not counters.get("pecos.batches"):
        return None
    return 1e-6 * counters["pecos.upload_bytes"] / counters["pecos.batches"]
