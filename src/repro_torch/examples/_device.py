"""The examples' ``--device`` argument."""
import sys

import torch


def add_device_arg(ap):
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")


def check_device(device: str):
    """Exit with a message when the card is asked for and there is none
    (nothing falls back to the CPU by itself)."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("--device cuda: no CUDA device is available "
                 "(--device cpu runs on the CPU)")
