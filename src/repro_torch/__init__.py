"""PyTorch + CUDA port of the BEV-SGD reproduction (the JAX package `repro`
is the reference).  Subpackages mirror `repro`'s layout: kernels, core,
models, configs, data, fl; `figures` builds the paper's Figs. 1-4 sweeps.
Nothing here imports JAX or `repro`."""
