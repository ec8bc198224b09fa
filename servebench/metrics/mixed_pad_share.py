"""the share of a mixed step's packed token positions that are padding:
100 x (1 - valid positions / B x T), summed over the traced slice's
``exec.enqueue.mixed`` spans (the counters ``pack_mixed`` returned)."""
from harness import program_spans


def read(run):
    return program_spans.mixed_pad_share(program_spans.session())
