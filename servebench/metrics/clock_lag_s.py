"""p90 over the streamed tokens of the sink's wall time minus the token's
time on the loop's clock (on_token's t): how far the program's virtual
clock runs behind the wall."""
from harness import readout


def read(run):
    return readout.clock_lag_s(run)
