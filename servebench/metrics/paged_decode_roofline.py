"""kernel 1 (kernels/csrc/paged_decode.cu): the least time of the slice's
calls (their bytes or FLOPs at the card's peaks) over the kernel's time
in the trace."""
from harness import readout


def read(run):
    return readout.roofline_share(run, "paged_decode")
