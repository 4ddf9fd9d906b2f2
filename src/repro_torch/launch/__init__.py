"""Launchers: the simulation CLI (``python -m repro_torch.launch.simulate``)."""
