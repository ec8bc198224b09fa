"""the most KV blocks in use at once over both instances' pools, as a share
of their blocks."""
from harness import readout


def read(run):
    return readout.kv_peak_share(run)
