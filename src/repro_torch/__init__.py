"""PyTorch + CUDA port of the BEV-SGD reproduction (the JAX package `repro`
is the reference).  Subpackages mirror `repro`'s layout: kernels, core,
models, configs, data, fl, checkpoint, launch, optim; `figures` builds the
paper's Figs. 1-4 sweeps and the real-model LM lane, `launch.train` trains
an LM and `launch.serve` serves one; `tree` lays nested parameter dicts out
in the JAX package's leaf order; `device` picks the entry points' device.
The sweep's public surface is exported here too, loaded on first use, with
the multi-process bootstrap (`initialize_distributed`, `fetch`) and the
sweep-mesh constructor (`make_sweep_mesh`), as `repro` exports them; the
reference's `setup_compilation_cache` has no counterpart (the port compiles
nothing at run time but its kernels, built once into build/kernels/).
Nothing here imports JAX or `repro`."""
import importlib

_EXPORTS = {
    "ExecutionPlan": "repro_torch.fl.plan",
    "ScenarioCase": "repro_torch.fl.sweep",
    "SweepEngine": "repro_torch.fl.sweep",
    "SweepResult": "repro_torch.fl.sweep",
    "SweepSpec": "repro_torch.fl.sweep",
    "run_sweep": "repro_torch.fl.sweep",
    "FLTrainer": "repro_torch.fl.trainer",
    "RoundLog": "repro_torch.fl.trainer",
    "save_pytree": "repro_torch.checkpoint.ckpt",
    "restore_pytree": "repro_torch.checkpoint.ckpt",
    "latest_step": "repro_torch.checkpoint.ckpt",
    "initialize_distributed": "repro_torch.launch.distributed",
    "fetch": "repro_torch.launch.distributed",
    "make_sweep_mesh": "repro_torch.launch.mesh",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'repro_torch' has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)
