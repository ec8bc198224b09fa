"""The reference's examples on the port: each runs as ``python -m
repro_torch.examples.<name>`` (``PYTHONPATH=src``), on the card unless
``--device cpu`` says otherwise."""
