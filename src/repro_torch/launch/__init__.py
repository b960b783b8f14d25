"""Launchers of the port: the decode step and the serving entry point
(`python -m repro_torch.launch.serve`)."""
