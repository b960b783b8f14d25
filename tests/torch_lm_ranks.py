"""Shared parts of the port's LM rank tests (tests/test_torch_lm_mesh*.py:
the worker axes; tests/test_torch_lm_tp*.py: the "model" axis): the JAX
package's reference run in a subprocess (or several at once) on host
devices (`jax_reference`), the train-step jobs of
tests/torch_dist_driver.py built from its results, and the checks of a
rank's train step against it.

The reference script (`JAX_REF`) runs, for the cases it is given:

- train: name -> (mesh shape, [(policy, use_floa)], arch, MoE impl,
  batch[, over]): the FLOA train step of `get_smoke(arch)` (its fields
  replaced by the dict `over`, when given) at model_parallel = the
  mesh's "model" size, STEPS steps of `batch` x SEQ + 1 tokens (a VLM's
  batch adds a prefix, an encoder-decoder's FRAMES frames: standard
  normal from numpy, `extra`), jitted on the ("data", "model") debug mesh;
  each step's draws replayed (gains off PRNGKey(t)'s first key, leaf i's
  noise off fold_in(second key, i), at the leaf's full shape);
- prefill: name -> (mesh shape, arch, batch, seq, seed[, over]) (an
  encoder-decoder's batch adds FRAMES frames, `extra`);
- decode: name -> (arch, batch, steps, seed[, over]): the one-device
  decode step teacher-forced from empty caches (the encoder-decoder's
  against the cross K / V of FRAMES frames).

Each file's run holds only its own cases, so its spawns and its JAX run
carry only its tests' jobs.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from torch_parity import assert_ranks_agree

from repro_torch.configs import get_smoke
from repro_torch.tree import tree_leaves, tree_paths

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
DECODE_RTOL = 1e-4
STEPS, SEQ, ALPHA, FRAMES = 3, 16, 0.02, 12
ROUTES = [("bev", True), ("ci", True), ("ef", True), ("bev", False)]
AXES = ("data", "model")

JAX_REF = textwrap.dedent("""
    import dataclasses, pickle, sys, warnings
    import numpy as np
    import jax
    import jax.numpy as jnp
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.configs import get_smoke
        from repro.core.channel import sample_channel_gains
        from repro.core.power_control import Policy
        from repro.data import sample_tokens
        from repro.launch import steps as S
        from repro.launch.mesh import make_debug_mesh
        from repro.models import encdec as ED
        from repro.models import transformer as T

    STEPS, SEQ, ALPHA, FRAMES = {steps}, {seq}, {alpha}, {frames}
    AXES = ("data", "model")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)


    def config(arch, m, impl=None, over=None):
        cfg = dataclasses.replace(get_smoke(arch), model_parallel=m,
                                  **(over or {{}}))
        if impl:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, impl=impl))
        return cfg


    def extra(cfg, batch, seed):
        g = np.random.default_rng(seed)
        fe = cfg.frontend
        if cfg.arch_type == "vlm":
            return {{"embeds_prefix": g.standard_normal(
                (batch, fe.n_prefix, fe.feature_dim)).astype(np.float32)}}
        if cfg.arch_type == "audio":
            return {{"frames": g.standard_normal(
                (batch, FRAMES, fe.feature_dim)).astype(np.float32)}}
        return {{}}


    def draws(mesh, dim, leaves):
        channel = S.default_floa(mesh, dim)["channel"]
        out = []
        for t in range(STEPS):
            k_ch, k_z = jax.random.split(jax.random.PRNGKey(t))
            out.append({{
                "h_abs": np.asarray(sample_channel_gains(k_ch, channel)),
                "z": [np.asarray(jax.random.normal(
                    jax.random.fold_in(k_z, i), x.shape, jnp.float32))
                    for i, x in enumerate(leaves)]}})
        return out


    def train(shape, routes, arch, impl, batch, over=None):
        cfg = config(arch, shape[1], impl, over)
        params, _ = S.init_model(cfg, jax.random.PRNGKey(0))
        mesh = make_debug_mesh(shape, AXES)
        seq = SEQ + (cfg.frontend.n_prefix if cfg.arch_type == "vlm" else 0)
        toks = [sample_tokens(batch, SEQ + 1, vocab=cfg.vocab_size, seed=t)
                for t in range(STEPS)]
        extras = [extra(cfg, batch, 100 + t) for t in range(STEPS)]
        res = {{"params0": np_tree(params), "tokens": toks,
               "extra": extras}}
        for policy, use_floa in routes:
            art = S.make_train_step(
                cfg, mesh, dict(global_batch=batch, seq_len=seq,
                                kind="train"),
                policy=Policy(policy), alpha=ALPHA, use_floa=use_floa)
            p, state, log = params, S.init_floa_state(), []
            with mesh:
                fn = jax.jit(art.fn, in_shardings=art.in_shardings)
                for t in range(STEPS):
                    b = {{"tokens": jnp.asarray(toks[t]),
                         **{{k: jnp.asarray(v)
                            for k, v in extras[t].items()}}}}
                    p, state, m = fn(p, state, b, jnp.uint32(t))
                    log.append({{**np_tree(state), **np_tree(m)}})
            res[(policy, use_floa)] = {{"params": np_tree(p), "log": log,
                                       "meta": art.meta}}
        res["draws"] = draws(mesh, art.meta["dim"],
                             jax.tree_util.tree_leaves(params))
        return res


    def prefill(shape, arch, b, s, seed, over=None):
        cfg = config(arch, shape[1], over=over)
        params, _ = S.init_model(cfg, jax.random.PRNGKey(0))
        mesh = make_debug_mesh(shape, AXES)
        art = S.make_prefill_step(cfg, mesh, dict(global_batch=b, seq_len=s,
                                                  kind="prefill"))
        toks = sample_tokens(b, s, vocab=cfg.vocab_size, seed=seed)
        ext = extra(cfg, b, seed)
        with mesh:
            logits = jax.jit(art.fn, in_shardings=art.in_shardings)(
                params, {{"tokens": jnp.asarray(toks),
                         **{{k: jnp.asarray(v) for k, v in ext.items()}}}})
        return {{"params0": np_tree(params), "tokens": toks, "extra": ext,
                "logits": np.asarray(logits)}}


    def decode(arch, batch, n, seed, over=None):
        cfg = config(arch, 1, over=over)
        params, _ = S.init_model(cfg, jax.random.PRNGKey(0))
        toks = sample_tokens(batch, n, vocab=cfg.vocab_size, seed=seed)
        out = {{"params0": np_tree(params), "tokens": toks}}
        if cfg.arch_type == "audio":
            out.update(extra(cfg, batch, seed))
            kv = ED.precompute_cross_kv(params, ED.encode(
                params, jnp.asarray(out["frames"]), cfg), cfg)
            caches = ED.init_dec_caches(cfg, batch, n)
            step = jax.jit(lambda p, c, t, pos: ED.decode_step(
                p, c, kv, t, pos, cfg))
        else:
            caches = T.init_caches(cfg, batch, n, window=cfg.window)
            step = jax.jit(lambda p, c, t, pos: T.decode_step(
                p, c, t, pos, cfg, window=cfg.window))
        logits = []
        for i in range(n):
            lg, caches = step(params, caches, jnp.asarray(toks[:, i:i + 1]),
                              jnp.int32(i))
            logits.append(np.asarray(lg[:, 0]))
        out["logits"] = np.stack(logits)
        return out


    out = {{name: train(*case) for name, case in {train}.items()}}
    out.update({{name: prefill(*case) for name, case in {prefill}.items()}})
    out.update({{name: decode(*case) for name, case in {decode}.items()}})
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    print("JAX_REF_OK", flush=True)
""")


def jax_reference(tmp_path_factory, devices, train=None, prefill=None,
                  decode=None, timeout=900, procs=1):
    """The JAX package's results of the given cases (`JAX_REF`), run once
    in subprocesses with `devices` host devices: {case name: result}.
    procs > 1 deals the cases out to that many subprocesses, which run at
    once (each compiles its own cases' programs)."""
    kinds = {"train": train or {}, "prefill": prefill or {},
             "decode": decode or {}}
    items = [(k, n, c) for k, cases in kinds.items() for n, c in
             cases.items()]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    runs = []
    for i in range(max(1, min(procs, len(items)))):
        part = {k: {} for k in kinds}
        for k, n, c in items[i::procs]:
            part[k][n] = c
        script = JAX_REF.format(steps=STEPS, seq=SEQ, alpha=ALPHA,
                                frames=FRAMES, **part)
        path = tmp_path_factory.mktemp("jax_ref") / "ref.pkl"
        runs.append((path, subprocess.Popen(
            [sys.executable, "-c", script, str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)))
    out = {}
    try:
        for path, p in runs:
            stdout, stderr = p.communicate(timeout=timeout)
            assert p.returncode == 0 and "JAX_REF_OK" in stdout, (
                stdout[-3000:] + stderr[-3000:])
            with open(path, "rb") as f:
                out.update(pickle.load(f))
    finally:
        for _, p in runs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def train_seq(arch):
    """The train steps' input-shape length: SEQ text positions, after a
    VLM's prefix (`steps.batch_shapes` lays a VLM's row out so)."""
    cfg = get_smoke(arch)
    return SEQ + (cfg.frontend.n_prefix if cfg.arch_type == "vlm" else 0)


def train_job(name, ref, mesh, policy, use_floa, arch, batch):
    """A train_step job for tests/torch_dist_driver.py from the reference's
    result `ref` of one case: its weights, tokens, frontend inputs and
    draws."""
    return dict(name=name, kind="train_step", mesh=mesh, arch=arch,
                params0=ref["params0"], tokens=ref["tokens"],
                extra=ref["extra"], draws=ref["draws"], policy=policy,
                use_floa=use_floa, alpha=ALPHA, batch=batch,
                seq=train_seq(arch))


def train_jobs(ref, name, cases):
    """The train jobs of case `name` of `cases` (`JAX_REF`'s train layout),
    one a route, named <name>_<policy>_<use_floa>; a case's config
    replacements go to the driver as the job's "config"."""
    shape, routes, arch, impl, batch, *over = cases[name]
    return [dict(train_job(f"{name}_{p}_{f}", ref[name], (shape, AXES), p,
                           f, arch, batch), moe_impl=impl,
                 config=over[0] if over else {})
            for p, f in routes]


def batch_only_jobs(ref, names, cases):
    """The first route's train job of each case in `names` on the
    "batch_only" route (the residual replicated over "model"), named
    <name>_batch_only: the same reference, which splits the sequence."""
    return [dict(train_jobs(ref, n, cases)[0], name=f"{n}_batch_only",
                 constrain="batch_only") for n in names]


def check_batch_only(ranks, jax_ref, world, name, cases):
    """A `batch_only_jobs` job against the reference's first route: every
    rank's gathered params and log bitwise equal, the route recorded in
    meta, the result at RTOL / ATOL; the case's own job took
    "sequence"."""
    route = cases[name][1][0]
    job = f"{name}_batch_only"
    assert_ranks_agree(ranks, job, world, skip=("worker", "model"))
    assert ranks[f"{job}.r0"]["meta"]["constrain"] == "batch_only"
    assert ranks[f"{name}_{route[0]}_{route[1]}.r0"]["meta"][
        "constrain"] == "sequence"
    assert_train_matches(ranks[f"{job}.r0"], jax_ref[name][route])


def decode_jobs(ref, world, meshes):
    """The decode jobs of `meshes` (arch -> its mesh shapes) whose meshes
    span `world` ranks, named decode_<arch>_<M>, from the reference's
    one-device decode run decode_<arch>."""
    return [dict(name=f"decode_{arch}_{shape[1]}", kind="decode",
                 mesh=(shape, AXES), arch=arch,
                 params0=ref["decode_" + arch]["params0"],
                 tokens=ref["decode_" + arch]["tokens"])
            for arch, shapes in meshes.items() for shape in shapes
            if shape[0] * shape[1] == world]


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def close_decode(logits, want):
    """Decode logits [steps, B, Vp] step by step at DECODE_RTOL, with an
    atol of DECODE_RTOL times the largest |want|."""
    assert logits.shape == want.shape
    for i, (g, w) in enumerate(zip(logits, want)):
        close(g, w, rtol=DECODE_RTOL,
              atol=DECODE_RTOL * float(np.abs(want).max()),
              err_msg=f"step {i}")


def flat(tree, prefix=""):
    """A nested dict of numpy leaves by "/"-joined sorted keys (the JAX leaf
    order)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_train_matches(got, want):
    """A rank's train-step result against the JAX run at RTOL / ATOL."""
    assert got["meta"]["num_workers"] == want["meta"]["num_workers"]
    assert got["meta"]["dim"] == want["meta"]["dim"]
    for t, (g, w) in enumerate(zip(got["log"], want["log"])):
        for k in ("gbar", "eps2", "loss", "grad_scale"):
            close(g[k], w[k], err_msg=f"step {t} {k}")
    jleaves = [v for _, v in sorted(flat(want["params"]).items())]
    for path, g, w in zip(tree_paths(got["params"]),
                          tree_leaves(got["params"]), jleaves):
        assert np.isfinite(w).all()
        close(g, w, err_msg=path)


def check_train(ranks, jax_ref, world, name, route, cases):
    """A train job on a model mesh: every rank's gathered params and log
    bitwise equal (the replicas and the replicated leaves), the ranks
    row-major over ("data", "model"), the shards 1/M of the split leaves,
    and the result against the JAX run on the same mesh."""
    policy, use_floa = route
    job = f"{name}_{policy}_{use_floa}"
    shape = cases[name][0]
    assert_ranks_agree(ranks, job, world, skip=("worker", "model"))
    first = ranks[f"{job}.r0"]
    assert [ranks[f"{job}.r{r}"]["model"] for r in range(world)] == [
        (shape[1], r % shape[1]) for r in range(world)]
    assert [ranks[f"{job}.r{r}"]["worker"] for r in range(world)] == [
        (shape[0], r // shape[1], 1) for r in range(world)]
    specs = tree_leaves(first["meta"]["params_specs"])
    for local, full, dim in zip(first["shapes"],
                                tree_leaves(first["params"]), specs):
        want = list(full.shape)
        if dim is not None:
            want[dim] //= shape[1]
        assert list(local) == want
    assert_train_matches(first, jax_ref[name][route])
