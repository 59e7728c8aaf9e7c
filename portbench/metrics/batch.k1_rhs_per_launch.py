"""batch.k1_rhs_per_launch: the program's ``k1_rhs`` counter (the
right-hand sides K1's launches served) over its ``k1`` counter (the
launches), over one solve of one chunk with tracing off (batch_trace.py):
1.0 while K1 serves one instance a launch, B once one launch serves the
batch's B. None where the program has no such counter or launched no K1."""

from portbench import batch_trace


def read(ctx):
    bt = batch_trace.get(ctx)
    return None if bt is None else bt.k1_rhs_per_launch
