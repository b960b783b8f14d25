"""Models of the port: the paper's MLP and the decoder-only LM of the
serving and training paths (`common`, `attention` with MLA, `ffn`, `moe`,
`ssm`, `transformer`)."""
from repro_torch.models.mlp import (init_mlp, mlp_accuracy, mlp_logits,
                                    mlp_loss, num_params, params_from_jax)

__all__ = ["init_mlp", "mlp_accuracy", "mlp_logits", "mlp_loss",
           "num_params", "params_from_jax"]
