"""mean ms of an iteration that carries prefill rows, between CUDA events
recorded before and after its dispatch (the host's enqueueing included
where it is slower than the device)."""
from harness import readout


def read(run):
    return readout.prefill_iter_ms(run)
