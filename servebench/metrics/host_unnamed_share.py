"""the share of the serving loop's host time (its ``loop.run`` spans) in
no named program span: ``loop.run``'s self time over its whole time, over
the traced slice."""
from harness import program_spans


def read(run):
    return program_spans.host_unnamed_share(program_spans.session())
