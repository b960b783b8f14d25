"""Launchers of the port: the train, prefill and decode steps, the training
entry point (`python -m repro_torch.launch.train`) and the serving entry
point (`python -m repro_torch.launch.serve`)."""
