"""Data of the port: the synthetic digits, the federated sampler (i.i.d.
or Dirichlet label-skew shards), the synthetic token streams and their
batcher."""
from repro_torch.data.pipeline import (FederatedSampler, TokenBatcher,
                                      dirichlet_worker_split,
                                      iter_chunk_blocks)
from repro_torch.data.synthetic_digits import make_dataset, worker_split
from repro_torch.data.text import (make_markov_tables, sample_tokens,
                                   stack_token_rounds)

__all__ = ["FederatedSampler", "TokenBatcher", "dirichlet_worker_split",
           "iter_chunk_blocks", "make_dataset", "make_markov_tables",
           "sample_tokens", "stack_token_rounds", "worker_split"]
