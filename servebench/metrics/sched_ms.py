"""host ms of the scheduling core an executor iteration: the self time of
the program's ``sched.*`` and ``cluster.*`` spans over the traced slice's
``exec.enqueue.*`` spans (a migration's ``migrate.*`` data movement
left out)."""
from harness import program_spans


def read(run):
    return program_spans.sched_ms(program_spans.session())
