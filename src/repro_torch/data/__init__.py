"""Data of the port: the synthetic digits and the federated sampler."""
from repro_torch.data.pipeline import FederatedSampler
from repro_torch.data.synthetic_digits import make_dataset, worker_split

__all__ = ["FederatedSampler", "make_dataset", "worker_split"]
