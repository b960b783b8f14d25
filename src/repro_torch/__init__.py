"""PyTorch + CUDA port of the BEV-SGD reproduction (the JAX package `repro`
is the reference).  Subpackages mirror `repro`'s layout: kernels, core,
models, configs, data, fl, launch; `figures` builds the paper's Figs. 1-4
sweeps, `launch.serve` serves an LM; `device` picks the entry points'
device.
Nothing here imports JAX or `repro`."""
