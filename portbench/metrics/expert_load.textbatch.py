"""expert_load.textbatch: how far the busiest expert's load stands above the
mean: 100 x ``pecos.moe.max_load`` / (``pecos.moe.pairs`` / experts), both
summed by the program over its expert-layer forwards (kept on the card,
moved into its registry after each predict's fetch); the experts a layer
routes over are the work's (``models/<model>_work.py``).  100 is balanced;
the layer's time follows its busiest expert.  None where the program keeps
no such counters or the work has no expert layers.  Over the whole process,
set-up calls included (``program_spans``)."""

from portbench import program_spans


def read(ctx):
    work = ctx.get("work")
    snap = program_spans.registry()
    if not work or "moe" not in work or not snap:
        return None
    pairs, busiest = snap["counters"].get("pecos.moe.pairs"), snap["counters"].get("pecos.moe.max_load")
    if not pairs or busiest is None:
        return None
    return 100.0 * busiest / (pairs / work["moe"]["experts"])
