"""tokenize_hidden_share.textbatch: percent of the blocks of texts the
encoder tokenized a block at a time (``pecos.tokenize.blocks``) whose
tokenizing ended while the card was still running the forward before them
(``pecos.tokenize.hidden``): the host's tokenizer hidden behind the card.
A call's first block is never hidden, so a call of 16 blocks reads at most
93.75%.  None where the program tokenizes no block on its own, and off the
card (no ``pecos.encode.device_us``), where no forward runs apart from the
host.  Over the whole process, set-up calls included (``program_spans``)."""

from portbench import program_spans


def read(ctx):
    snap = program_spans.registry()
    blocks = snap and snap["counters"].get("pecos.tokenize.blocks")
    if not blocks or not snap["counters"].get("pecos.encode.device_us"):
        return None
    return 100.0 * snap["counters"].get("pecos.tokenize.hidden", 0) / blocks
