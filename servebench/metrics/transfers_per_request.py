"""flowing-decode migrations (cluster.transfer_count) over the requests the
run finished."""
from harness import readout


def read(run):
    return readout.transfers_per_request(run)
