"""mean device ms of one decode step inside replayed graphs: CUDA events
around the dispatch, over the horizon K."""
from harness import readout


def read(run):
    return readout.decode_step_ms(run)
