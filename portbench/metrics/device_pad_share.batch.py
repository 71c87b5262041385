"""device_pad_share.batch: percent of the program's batches whose padded query
block was built on the card from the batch's CSR slice: 100 x
``pecos.pad.device`` / ``pecos.batches``.  None where the program keeps no
such counter, as one that pads every batch on the host.  Over the whole
process, set-up batches included (``program_spans``)."""

from portbench import program_spans


def read(ctx):
    snap = program_spans.registry()
    counters = snap["counters"] if snap else {}
    if "pecos.pad.device" not in counters or not counters.get("pecos.batches"):
        return None
    return 100.0 * counters["pecos.pad.device"] / counters["pecos.batches"]
