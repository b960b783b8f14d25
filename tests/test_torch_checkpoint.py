"""The port's checkpoint format (`repro_torch.checkpoint`): the cases of
tests/test_checkpoint.py on the port's module, and the format read both
ways across the two packages.

Contracts restated: byte-exact round-trips for every dtype (bfloat16, fp8,
complex, wide and narrow ints, bool) and container structure, with and
without a template; `latest_step` ignores uncommitted and foreign files;
a failed write leaves no temp files; the manifest's rename is the commit;
the params / opt_state shims.  Across packages: a tree with bf16 and fp8
leaves written by `repro.checkpoint.write_tree` reads byte-exact in the
port, and the port's reads byte-exact in the JAX package.  Exact equality
throughout: the format stores bytes.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import jax.numpy as jnp
    import ml_dtypes
    from repro import checkpoint as JCK

from repro_torch import checkpoint as CK
from repro_torch.checkpoint import ckpt as CKM


def _carry_like_tree():
    """The shape of the sweep engine's resume carry: a state tuple with a
    complex element, generator states, nested dicts, host blocks."""
    return {
        "carry": {
            "state": (torch.arange(12, dtype=torch.float32).reshape(3, 4),
                      (torch.ones((3, 4, 2), dtype=torch.complex64)
                       * (0.5 - 2j), torch.zeros((3,), dtype=torch.int32))),
            "rng": torch.arange(48, dtype=torch.uint8).reshape(3, 16),
        },
        "blocks": {"loss": np.linspace(0, 1, 6).reshape(2, 3)},
    }


def _leaves(tree):
    return list(CKM._flatten_with_paths(tree).values())


def _assert_leaves_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype, (x.dtype, y.dtype)
        assert x.shape == y.shape
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))


def _bytes_of(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


# ------------------------------------------------------------- round-trip


def test_roundtrip_with_template_preserves_tuples(tmp_path):
    tree = _carry_like_tree()
    CK.save_pytree(str(tmp_path), 5, tree, extra={"t_next": 10})
    got, meta = CK.restore_pytree(str(tmp_path), 5, template=tree)
    assert isinstance(got["carry"]["state"], tuple)
    assert isinstance(got["carry"]["state"][1], tuple)
    _assert_leaves_equal(tree, got)
    assert meta["extra"] == {"t_next": 10, "step": 5}
    assert meta["format_version"] == CK.FORMAT_VERSION


def test_roundtrip_path_rebuild_without_template(tmp_path):
    tree = _carry_like_tree()
    CK.save_pytree(str(tmp_path), 0, tree)
    got, _ = CK.restore_pytree(str(tmp_path))
    assert isinstance(got["carry"]["state"], list)
    _assert_leaves_equal(tree, got)
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in _leaves(got))


def test_roundtrip_extension_and_wide_dtypes_bitwise(tmp_path):
    """bf16, both fp8 formats and complex leaves byte-exact; the dtypes
    numpy lacks ride as raw bytes under their ml_dtypes names."""
    g = torch.Generator().manual_seed(0)
    f32 = torch.randn((5, 3), generator=g)
    tree = {
        "bf16": f32.to(torch.bfloat16),
        "e4m3": f32.to(torch.float8_e4m3fn),
        "e5m2": f32.to(torch.float8_e5m2),
        "c64": torch.complex(f32[:, :2], f32[:, 1:]),
        "f64": torch.randn(4, dtype=torch.float64, generator=g),
        "i32": torch.arange(-3, 3, dtype=torch.int32),
        "u8": np.arange(6, dtype=np.uint8),
        "b": torch.tensor([True, False, True]),
        "scalar_bf16": torch.tensor(1.5, dtype=torch.bfloat16),
    }
    CK.save_pytree(str(tmp_path), 1, tree)
    got, meta = CK.restore_pytree(str(tmp_path), 1, template=tree)
    _assert_leaves_equal(tree, got)
    assert set(meta["packed"]) == {"bf16", "e4m3", "e5m2", "scalar_bf16"}
    assert meta["dtypes"]["bf16"] == "bfloat16"
    assert meta["dtypes"]["e4m3"] == "float8_e4m3fn"
    assert meta["dtypes"]["c64"] == "complex64"
    assert got["e5m2"].dtype == torch.float8_e5m2
    assert got["scalar_bf16"].shape == ()


def test_unknown_dtype_name_raises_naming_it(tmp_path):
    CK.save_pytree(str(tmp_path), 1,
                   {"x": torch.zeros(2, dtype=torch.bfloat16)})
    meta_path = tmp_path / "ckpt_1.meta.json"
    meta = json.loads(meta_path.read_text())
    meta["dtypes"]["x"] = "float4_e2m1"
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="float4_e2m1"):
        CK.restore_pytree(str(tmp_path), 1)


def test_roundtrip_bare_leaf_and_scalar(tmp_path):
    CK.save_pytree(str(tmp_path), 2, torch.arange(4.0))
    got, _ = CK.restore_pytree(str(tmp_path), 2)
    assert torch.equal(got, torch.arange(4.0))
    CK.save_pytree(str(tmp_path), 3, {"t": np.int64(12)})
    got, _ = CK.restore_pytree(str(tmp_path), 3)
    assert int(got["t"]) == 12


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        CK.restore_pytree(str(tmp_path / "nowhere"))


# ------------------------------------------------------------ latest_step


def test_latest_step_empty_and_missing_dirs(tmp_path):
    assert CK.latest_step(str(tmp_path / "absent")) is None
    assert CK.latest_step(str(tmp_path)) is None


def test_latest_step_ignores_uncommitted_and_foreign_files(tmp_path):
    CK.save_pytree(str(tmp_path), 3, {"a": np.zeros(2)})
    CK.save_pytree(str(tmp_path), 10, {"a": np.ones(2)})
    (tmp_path / "ckpt_99.npz").write_bytes(b"torn")     # no manifest
    (tmp_path / "ckpt_abc.npz").write_bytes(b"x")
    (tmp_path / "notes.txt").write_text("hi")
    (tmp_path / "ckpt_7.meta.json").write_text("{}")    # no payload
    assert CK.latest_step(str(tmp_path)) == 10
    got, _ = CK.restore_pytree(str(tmp_path))
    assert torch.equal(got["a"], torch.ones(2, dtype=torch.float64))


# -------------------------------------------------------------- atomicity


def test_failed_payload_write_leaves_no_litter(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(CKM.np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        CK.save_pytree(str(tmp_path), 4, {"a": np.zeros(3)})
    assert os.listdir(tmp_path) == []
    assert CK.latest_step(str(tmp_path)) is None


def test_failed_meta_write_is_not_committed(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(CKM.json, "dump", boom)
    with pytest.raises(OSError, match="disk full"):
        CK.save_pytree(str(tmp_path), 4, {"a": np.zeros(3)})
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    assert CK.latest_step(str(tmp_path)) is None


def test_rewrite_decommits_before_the_payload_swap(tmp_path, monkeypatch):
    """Rewriting a committed step that fails after the old manifest is
    unlinked leaves the step uncommitted, never the old manifest over a
    new payload."""
    CK.save_pytree(str(tmp_path), 2, {"a": np.zeros(3)})
    real = CKM.os.replace

    def fail_commit(src, dst):
        if dst.endswith(".meta.json"):
            raise OSError("lost power")
        return real(src, dst)

    monkeypatch.setattr(CKM.os, "replace", fail_commit)
    with pytest.raises(OSError, match="lost power"):
        CK.save_pytree(str(tmp_path), 2, {"a": np.ones(3)})
    assert CK.latest_step(str(tmp_path)) is None
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_meta_rename_is_the_commit_point(tmp_path):
    CK.save_pytree(str(tmp_path), 6, {"a": np.zeros(3)})
    assert json.loads(
        (tmp_path / "ckpt_6.meta.json").read_text())["extra"]["step"] == 6
    os.remove(tmp_path / "ckpt_6.meta.json")
    assert CK.latest_step(str(tmp_path)) is None


def test_legacy_save_restore_shims(tmp_path):
    params = {"w": torch.ones((3, 2)),
              "nested": {"b": torch.arange(4).to(torch.bfloat16)}}
    opt = (torch.zeros(3), {"m": torch.full((2,), 2.0)})
    CK.save(str(tmp_path), 42, params, opt, extra={"note": "x"})
    assert CK.latest_step(str(tmp_path)) == 42
    p2, o2, meta = CK.restore(str(tmp_path), 42, params, opt)
    assert p2["nested"]["b"].dtype == torch.bfloat16
    assert meta["extra"]["note"] == "x"
    _assert_leaves_equal(params, p2)
    _assert_leaves_equal(opt, o2)
    assert isinstance(o2, tuple)


# ------------------------------------------------------- across packages


def _cross_tree_numpy():
    """bf16 and fp8 (e4m3fn) leaves as the JAX package writes them.  Not
    e5m2: the installed ml_dtypes reports float8_e5m2 as kind "f", so the
    reference's writer stores it unpacked as "<f1", which np.load cannot
    read in either package (ROADMAP.md Queue 3, reference caveat)."""
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((4, 6)).astype(np.float32)
    return {"bf16": f32.astype(ml_dtypes.bfloat16),
            "e4m3": f32.astype(ml_dtypes.float8_e4m3fn),
            "nested": {"f32": f32, "c64": (f32 + 2j * f32).astype(
                np.complex64), "i64": np.arange(5)},
            "seq": [np.float32(3.5), np.array([True, False])]}


def test_jax_package_checkpoint_reads_byte_exact_in_the_port(tmp_path):
    tree = _cross_tree_numpy()
    tree["bf16_jnp"] = jnp.asarray(tree["nested"]["f32"], jnp.bfloat16)
    JCK.write_tree(str(tmp_path / "j"), tree, extra={"from": "jax"})
    got, meta = CK.read_tree(str(tmp_path / "j"))
    assert meta["extra"] == {"from": "jax"}
    want = {k: np.asarray(v) for k, v in
            JCK.ckpt._flatten_with_paths(tree).items()}
    flat = CKM._flatten_with_paths(got)
    assert set(flat) == set(want)
    for k, w in want.items():
        assert str(flat[k].dtype).replace("torch.", "") == str(w.dtype), k
        assert tuple(flat[k].shape) == w.shape, k
        assert _bytes_of(flat[k]) == w.tobytes(), k


def test_port_packs_every_ml_dtypes_array(tmp_path):
    """A numpy leaf of an ml_dtypes dtype (e5m2 included) is byte-packed
    under its name and restores as the torch dtype of that name."""
    f32 = np.linspace(-2, 2, 6, dtype=np.float32)
    tree = {n: f32.astype(getattr(ml_dtypes, n))
            for n in ("bfloat16", "float8_e4m3fn", "float8_e5m2")}
    CK.write_tree(str(tmp_path / "m"), tree)
    got, meta = CK.read_tree(str(tmp_path / "m"))
    assert sorted(meta["packed"]) == sorted(tree)
    for n, a in tree.items():
        assert got[n].dtype == getattr(torch, n)
        assert _bytes_of(got[n]) == a.tobytes()


def test_port_checkpoint_reads_byte_exact_in_the_jax_package(tmp_path):
    g = torch.Generator().manual_seed(2)
    f32 = torch.randn((4, 6), generator=g)
    tree = {"bf16": f32.to(torch.bfloat16),
            "e4m3": f32.to(torch.float8_e4m3fn),
            "e5m2": f32.to(torch.float8_e5m2),
            "nested": {"f32": f32, "c64": torch.complex(f32, 2 * f32),
                       "i64": torch.arange(5)},
            "seq": [torch.tensor(3.5), np.array([True, False])]}
    CK.write_tree(str(tmp_path / "t"), tree, extra={"from": "torch"})
    got, meta = JCK.read_tree(str(tmp_path / "t"))
    assert meta["extra"] == {"from": "torch"}
    want = CKM._flatten_with_paths(tree)
    flat = {k: np.asarray(v)
            for k, v in JCK.ckpt._flatten_with_paths(got).items()}
    assert set(flat) == set(want)
    for k, w in want.items():
        w_name = str(torch.as_tensor(w).dtype).replace("torch.", "")
        assert str(flat[k].dtype) == w_name, k
        assert flat[k].shape == tuple(torch.as_tensor(w).shape), k
        assert flat[k].tobytes() == _bytes_of(w), k


def test_port_sources_import_no_jax_repro_or_ml_dtypes():
    """No module of the port, and not chip_smoke.py, imports JAX, the JAX
    package or ml_dtypes (which ships with JAX and is not on the card's
    machine): the format's extension dtypes go through torch."""
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parents[1]
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)", re.M)
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    files.append(root / "tests" / "torch_dist_driver.py")
    assert len(files) > 40
    for new in ("tree.py", "optim/optimizers.py", "optim/schedules.py",
                "launch/train.py", "launch/steps.py",
                "launch/distributed.py", "launch/mesh.py", "models/moe.py",
                "configs/granite_8b.py", "configs/starcoder2_3b.py",
                "configs/moonshot_v1_16b_a3b.py",
                "configs/llama4_maverick_400b_a17b.py"):
        assert root / "src" / "repro_torch" / new in files, new
    bad = [str(f.relative_to(root)) for f in files
           if pattern.search(f.read_text())]
    assert not bad, bad

