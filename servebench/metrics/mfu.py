"""model FLOPs of every token the traced slice computed (attention
included, counted from the served shapes by harness/count.py) over the
slice's seconds times the card's bf16 peak."""
from harness import readout


def read(run):
    return readout.mfu(run)
