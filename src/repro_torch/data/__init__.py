"""data layer of the PyTorch port (see repro_torch)."""
