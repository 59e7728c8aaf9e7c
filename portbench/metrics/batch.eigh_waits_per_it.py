"""batch.eigh_waits_per_it: the program's ``eigh_waits`` counter (eigh
segments the chunk runner ran between two graph parts, one host wait
each) over one solve of one chunk with tracing off, over its
instance-iterations (batch_trace.py): 0 where no bucket projects by eigh.
None where the program has no such counter."""

from portbench import batch_trace


def read(ctx):
    bt = batch_trace.get(ctx)
    return None if bt is None else bt.eigh_waits_per_it
