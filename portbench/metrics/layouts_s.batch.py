"""layouts_s.batch: host seconds in the program's span ``pecos.layouts``, its
build of every layer's device layout (``build_device_layer``: the packed and
parent-grouped plabel arrays or the dense W, and their upload), a part of
set-up; the program builds each layer once a run (``program_spans``)."""

from portbench import program_spans


def read(ctx):
    return program_spans.span_s("pecos.layouts")
