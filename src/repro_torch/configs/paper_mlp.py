"""The paper's own experiment config (§IV): MLP 784-64-10 on 28x28 digits,
U=10 workers, 3000 training samples, SNR 10 dB, Rayleigh CN(0,1) channels."""
import dataclasses

ARCH_ID = "paper-mlp"


@dataclasses.dataclass(frozen=True)
class PaperMLPConfig:
    d_in: int = 784
    d_hidden: int = 64
    n_classes: int = 10
    num_workers: int = 10
    train_samples: int = 3000
    test_samples: int = 1000
    batch_per_worker: int = 32
    snr_db: float = 10.0
    sigma: float = 1.0
    p_max: float = 1.0

    @property
    def dim(self) -> int:  # D = 50890, as in the paper
        return (self.d_in * self.d_hidden + self.d_hidden
                + self.d_hidden * self.n_classes + self.n_classes)


def full() -> PaperMLPConfig:
    return PaperMLPConfig()


def smoke() -> PaperMLPConfig:
    return dataclasses.replace(full(), train_samples=200, test_samples=100,
                               batch_per_worker=8)


# The paper's parameter count; the flat sweep state, the kernels' D and the
# JAX parity tests all rest on it.
assert full().dim == 50890, full().dim
