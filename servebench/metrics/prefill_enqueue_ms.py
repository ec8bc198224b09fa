"""mean host ms to enqueue a step with prefill rows: the self time of the
program's ``exec.enqueue.mixed`` spans (packing, block tables, copies to
the card, the eager launches) over the traced slice."""
from harness import program_spans


def read(run):
    return program_spans.prefill_enqueue_ms(program_spans.session())
