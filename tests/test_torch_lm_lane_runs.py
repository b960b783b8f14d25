"""The port's LM lane over longer runs, on test_torch_lm_lane.py's tiny
lane and helpers (the lm_sweep config shrunk to D = 69 856, U = 8 workers
of 2 sequences of 48 tokens, 3 attackers, the JAX engine's replayed
draws): `test_lm_lane.py`'s 30-round separation claims, a checkpointed
tree-state run resumed bitwise, `figures.run_lm_lane` on the CPU, and
`figures.lm_lanes` against examples/train_floa_lm.py.
"""
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

with warnings.catch_warnings():
    # The installed jax deprecates jax.experimental.shard_map, which the JAX
    # package imports; the reference is left as it is.
    warnings.simplefilter("ignore", DeprecationWarning)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_lm_lane import LR, N_ATK, SEQ, _check_separation
    from test_torch_lm_lane import (ROUNDS, ROUNDS_LONG, _bitwise,
                                    _port_cfg, _port_run, _problem)

from repro_torch import figures as TF
from repro_torch.checkpoint import latest_step
from repro_torch.fl import ExecutionPlan
from repro_torch.fl import sweep as TS
from repro_torch.kernels import ops as tops
from torch_parity import jax_case


def test_lm_lane_attack_and_screening_separation():
    """test_lm_lane.py's 30-round claims, restated under the JAX engine's
    replayed draws: clean descends, the sign-flip lane ends above its start
    and above clean, median screening recovers descent."""
    res = _port_run(ROUNDS_LONG)
    assert res.loss.shape == (3, ROUNDS_LONG)
    _check_separation(res, ROUNDS_LONG)


def test_lm_lane_tree_state_resumes_bitwise(tmp_path):
    """The tree state (nested leaves [S, ...]) through a checkpoint: a
    fresh engine resumes from the last committed boundary (round 4 of 6)
    and ends bitwise as the uninterrupted run."""
    plan = ExecutionPlan(flat_state=False, chunk_rounds=2,
                         checkpoint_dir=str(tmp_path))
    full = _port_run(ROUNDS, plan)
    assert latest_step(str(tmp_path)) == 4
    loss, params0, _, batches, spec, _, draws = _problem(ROUNDS)
    resumed = TS.SweepEngine(loss, spec, plan=plan, device="cpu").run(
        params0, batches, draws=draws, resume=True)
    _bitwise(resumed, full)


def test_run_lm_lane_on_the_cpu():
    """The example's entry point on the CPU (plain versions, no launch):
    three lanes by name, finite, clean descending over 8 rounds; the
    example's --model-shards in one process (its ("model",) mesh needs a
    rank a shard, tests/test_torch_model_sharded.py) and a resume without
    a directory raise."""
    tops.reset_launches()
    res = TF.run_lm_lane(8, cfg=_port_cfg(), seq=SEQ, byzantine=N_ATK,
                         lr=LR, device="cpu")
    assert tops.launch_counts() == {k: 0 for k in tops.KERNELS}
    assert res.names == ("bev-clean", "bev-signflip", "median-signflip")
    assert res.loss.shape == (3, 8) and np.isfinite(res.loss).all()
    tail = max(1, 8 // 5)
    clean = res.loss[0]
    assert np.mean(clean[-tail:]) < clean[0]
    assert res.params["embed"].shape == (3, 256, 64)
    with pytest.raises(AssertionError, match="model_shards=2"):
        TF.run_lm_lane(2, cfg=_port_cfg(), device="cpu", model_shards=2)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        TF.run_lm_lane(2, cfg=_port_cfg(), device="cpu", resume=True)


def test_lm_lanes_match_the_example():
    """figures.lm_lanes is examples/train_floa_lm.py::lm_lanes."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from train_floa_lm import lm_lanes as jlm_lanes
    got = [jax_case(c) for c in TF.lm_lanes(8, 2_950_528, 2, 0.2)]
    assert got == jlm_lanes(8, 2_950_528, 2, 0.2)
