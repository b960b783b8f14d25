"""The port's data, config and model (`repro_torch.data`, `configs`,
`models`) against the JAX package: byte-equal data at the same seeds, the
paper config, and the MLP's loss and per-worker gradients through weights
carried across with `params_from_jax`."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.configs import paper_mlp as JPM
    from repro.core.aggregation import flatten_worker_grads, per_worker_grads
    from repro.data import pipeline as JP
    from repro.data import synthetic_digits as JD
    from repro.models import mlp as JM

from repro_torch.configs import paper_mlp as TPM
from repro_torch.core import aggregation as TAG
from repro_torch.data import pipeline as TP
from repro_torch.data import synthetic_digits as TD
from repro_torch.fl.sweep import make_row_unflatten
from repro_torch.models import mlp as TM


@pytest.mark.parametrize("seed", [0, 1, 99])
def test_dataset_byte_equal(seed):
    tx, ty = TD.make_dataset(40, seed=seed)
    jx, jy = JD.make_dataset(40, seed=seed)
    assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()


def test_dataset_is_rendered_once_and_returned_as_copies():
    """A second call with the same (n, seed) takes the kept render: equal
    bytes, writable arrays of its own (a caller's writes reach neither
    the kept arrays nor the next call), the JAX bytes still."""
    TD._rendered.cache_clear()
    x, y = TD.make_dataset(30, seed=5)
    x[:] = -1.0
    y[:] = -1
    x2, y2 = TD.make_dataset(30, seed=5)
    assert TD._rendered.cache_info().hits == 1
    assert x2.flags.writeable and not np.shares_memory(x, x2)
    jx, jy = JD.make_dataset(30, seed=5)
    assert x2.tobytes() == jx.tobytes() and y2.tobytes() == jy.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 99])
def test_split_and_sampler_byte_equal(seed):
    x, y = JD.make_dataset(60, seed=seed)
    ts, js = TD.worker_split(x, y, 4, seed=seed), JD.worker_split(x, y, 4,
                                                                  seed=seed)
    assert ts.keys() == js.keys()
    for i in ts:
        assert ts[i][0].tobytes() == js[i][0].tobytes()
        assert ts[i][1].tobytes() == js[i][1].tobytes()
    tb = TP.FederatedSampler(ts, 3, seed=seed).stack_rounds(4)
    jb = JP.FederatedSampler(js, 3, seed=seed).stack_rounds(4)
    assert tb.keys() == jb.keys()
    for k in tb:
        assert tb[k].shape == (4, 12, *tb[k].shape[2:])
        assert tb[k].tobytes() == jb[k].tobytes()
    s1, s2 = TP.FederatedSampler(ts, 3, seed=seed), JP.FederatedSampler(
        js, 3, seed=seed)
    r1, r2 = s1.next_round(), s2.next_round()
    assert r1["x"].tobytes() == r2["x"].tobytes()
    assert s1.num_workers == s2.num_workers == 4


def test_paper_config_matches():
    assert dataclasses.asdict(TPM.full()) == dataclasses.asdict(JPM.full())
    assert dataclasses.asdict(TPM.smoke()) == dataclasses.asdict(JPM.smoke())
    assert TPM.full().dim == JPM.full().dim == 50890
    assert TPM.ARCH_ID == JPM.ARCH_ID


def _model_inputs(d_hidden=16, batch=24, seed=0):
    jp = JM.init_mlp(jax.random.PRNGKey(seed), d_hidden=d_hidden)
    x, y = JD.make_dataset(batch, seed=seed)
    x = x.astype(np.float32)
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jp, tp, x, y


@pytest.mark.parametrize("d_hidden", [16, 64])
def test_mlp_loss_logits_accuracy_match_jax(d_hidden):
    jp, tp, x, y = _model_inputs(d_hidden)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    batch_t = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    batch_j = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    np.testing.assert_allclose(float(TM.mlp_loss(tp, batch_t)),
                               float(JM.mlp_loss(jp, batch_j)), rtol=1e-5)
    np.testing.assert_allclose(TM.mlp_logits(tp, batch_t["x"]).numpy(),
                               np.asarray(JM.mlp_logits(jp, batch_j["x"])),
                               rtol=1e-5, atol=1e-5)
    assert float(TM.mlp_accuracy(tp, batch_t["x"], batch_t["y"])) == \
        pytest.approx(float(JM.mlp_accuracy(jp, batch_j["x"], batch_j["y"])))
    assert TM.num_params(tp) == JM.num_params(jp)


def test_per_worker_grads_match_jax():
    """vmap(grad) over U worker shards of the batch, dict params, and the
    same through the flat row (sorted-key order) the sweep differentiates."""
    u = 4
    jp, tp, x, y = _model_inputs(16, batch=u * 6, seed=3)
    jg, _ = per_worker_grads(JM.mlp_loss, jp, {"x": jnp.asarray(x),
                                               "y": jnp.asarray(y)}, u)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    tg = TAG.per_worker_grads(TM.mlp_loss, tp, batch, u)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6)
    jflat, _ = flatten_worker_grads(jg)
    unflatten_row, _ = make_row_unflatten(tp)
    row, _ = TAG.flatten_worker_grads({k: v[None] for k, v in tp.items()})
    flat = TAG.per_worker_grads(
        lambda w, b: TM.mlp_loss(unflatten_row(w), b), row[0], batch, u)
    assert flat.shape == (u, row.shape[1])
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        TAG.per_worker_grads(TM.mlp_loss, tp, batch, 5)


def test_init_mlp_is_he_normal():
    gen = torch.Generator().manual_seed(0)
    p = TM.init_mlp(gen)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (784, 64), "b1": (64,), "w2": (64, 10), "b2": (10,)}
    assert TM.num_params(p) == 50890
    assert not p["b1"].any() and not p["b2"].any()
    for k, fan_in in (("w1", 784), ("w2", 64)):
        std = float(p[k].std())
        want = (2.0 / fan_in) ** 0.5
        assert abs(std / want - 1.0) < 0.1, (k, std, want)
    again = TM.init_mlp(torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)
