"""Checkpoints in the JAX package's tree format (`<base>.npz` +
`<base>.meta.json`), read and written without JAX."""
from repro_torch.checkpoint.ckpt import (FORMAT_VERSION, latest_step,
                                         read_tree, restore, restore_pytree,
                                         save, save_pytree, write_tree)

__all__ = ["FORMAT_VERSION", "latest_step", "read_tree", "restore",
           "restore_pytree", "save", "save_pytree", "write_tree"]
