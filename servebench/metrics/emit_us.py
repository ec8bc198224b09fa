"""host microseconds a streamed token: the self time of the program's
``loop.emit`` spans (telemetry, handles, the token sink) over the tokens
they streamed, over the traced slice."""
from harness import program_spans


def read(run):
    return program_spans.emit_us(program_spans.session())
