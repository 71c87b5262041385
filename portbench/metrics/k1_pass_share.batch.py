"""k1_pass_share.batch: percent of K1's query chunks whose candidate rows its
blocks read: 100 x ``pecos.k1.passes`` / ``pecos.k1.chunks``.  A block stages
a query padded to Qn slots in chunks of up to 512 and reads its rows once
for each chunk it probes; 100% is a pass for every chunk.  None where the
program keeps no such counters, as one that probes every chunk.  Over the
whole process, set-up batches included (``program_spans``)."""

from portbench import program_spans


def read(ctx):
    snap = program_spans.registry()
    counters = snap["counters"] if snap else {}
    if "pecos.k1.passes" not in counters or not counters.get("pecos.k1.chunks"):
        return None
    return 100.0 * counters["pecos.k1.passes"] / counters["pecos.k1.chunks"]
