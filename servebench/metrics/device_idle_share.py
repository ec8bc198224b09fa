"""the share of the traced slice in which no operation ran on the card."""
from harness import readout


def read(run):
    return readout.device_idle_share(run)
