"""algebra.launched_ms_per_it: device milliseconds an iteration of the ops
launched inside the program's ``layer.algebra`` span: the rest of the step: its elementwise algebra and reductions, outside the other three layers.
From the layered trace of program_trace.py (graphs cut at each layer
boundary, each part replayed inside its layer's span); None where the
program has no such spans or the trace links more than 1% of the device
time to no launch."""

from portbench import program_trace


def read(ctx):
    return program_trace.layer_ms_per_it(ctx, "algebra")
