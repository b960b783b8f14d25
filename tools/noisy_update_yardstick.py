#!/usr/bin/env python3
"""`csrc/noisy_update.cu` against an earlier version of it, on one card.

    PYTHONPATH=src python tools/noisy_update_yardstick.py --old DIR
        [--new DIR] [--only old|new] [--no-timing] [--out DIR]

DIR holds a `noisy_update.cu` and the `philox.cuh` it includes, e.g. an
earlier commit's, written out with `git show <commit>:<path>`; `--new`
defaults to this checkout's `src/repro_torch/kernels/csrc`.  Each version
is built with `_build.NVCC_FLAGS` into OUT/<label>/ (default
`build/noisy_yardstick`) and called through ctypes with
`_build.SIGNATURES["noisy_update"]`, so both run on the same tensors.
`--only` builds and measures one version (the starting point, before a
redesign); `--no-timing` stops before the timings (a new kernel's first,
short call).  One JSON line each, all of them also in OUT/lines.jsonl:

- `device`: nvidia-smi's name and power limit, torch and CUDA.
- `ptxas`: registers, spill bytes and shared memory of every instance of
  `noisy_sgd_kernel<T, MODE>` and `counter_trunc_normal_kernel<T>`.
- `sass`: each instance's instruction mix (`tools/sass_mix.py`: the hot
  path of its storing loop, per element, by opcode and by unit) and the
  count of sinf / cosf range reductions in it (compares with 105615.0f,
  libdevice's Payne-Hanek threshold); the listing in OUT/<label>.sass.
- `clock`: the SM clock `nvidia-smi -q -d CLOCK` reads while the bf16
  update runs at the embedding, in MHz.
- `sincos` (new): `sincosf` against `cosf` and `sinf` on every angle
  2 pi u of the stream's 2^23 uniforms, bit for bit.
- `bitwise` (both): for each case below, every part, the three modes of
  `noisy_sgd` and `counter_trunc_normal`, both dtypes: the two versions'
  outputs equal bit for bit.
- `timing`: ms a call (CUDA-graph replays, `chip_smoke.time_ms`) in the
  order old, new, new, old, with the SM clock and power nvidia-smi reads
  every 100 ms meanwhile, beside the bytes bound and the issue bound of
  the instance's SASS at the clock measured first;
  `torch.nn.init.trunc_normal_` on the same bf16 tensor beside
  `counter_trunc_normal`.

Cases: qwen3-4b's embedding [152064, 2560] and stacked wk [36, 2560,
1024]; the (16, 36, 20) leaf in (16, 4) parts (rows of 5); wk split 16
ways on its last dim (rows of 64; timed also as one row of as many
elements); a [16, 2^28 + 2^26] leaf in (16, 16)
parts (indices past 2^32); wk in (2, 16) parts and a part of a [6, 40,
24] leaf, of three dims after merging (the row table); rows starting at
j = 1, 2, 3 (mod 4); rows of 4, 12, 20; p and g at an odd element
offset (no 16-byte alignment); tails of 3 and 4099 elements.
Imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import sass_mix as SM  # noqa: E402
from chip_smoke import HBM_BYTES_PER_S, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import noisy_update as NU  # noqa: E402
from repro_torch.kernels import philox as P  # noqa: E402

SEED, LEAF, ALPHA = (11 << 36) + 5, 7, 0.02
EMB, WK = (152064, 2560), (36, 2560, 1024)
BIG, BIG_RANKS = (16, 2 ** 28 + 2 ** 26), (16, 16)
TRIG_THRESHOLD = "105615"   # libdevice's Payne-Hanek threshold
SINCOS_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void sincos_check(unsigned long long* bad) {
  const uint32_t m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (1u << 23)) return;
  const float u = __fmul_rn(__fadd_rn(__uint2float_rn(m), 0.5f),
                            1.1920928955078125e-07f);
  const float t = __fmul_rn(6.28318548202514648f, u);
  float s, c;
  sincosf(t, &s, &c);
  if (__float_as_uint(s) != __float_as_uint(sinf(t)) ||
      __float_as_uint(c) != __float_as_uint(cosf(t)))
    atomicAdd(bad, 1ull);
}
extern "C" int sincos_check_all(void* bad) {
  sincos_check<<<(1u << 23) / 256, 256>>>(
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def emit(out_dir: str, what: str, **fields) -> None:
    line = json.dumps({"yardstick": what, **fields})
    print(line, flush=True)
    with open(os.path.join(out_dir, "lines.jsonl"), "a") as f:
        f.write(line + "\n")


def build(label: str, src_dir: str, out_dir: str):
    """nvcc of src_dir/noisy_update.cu into out_dir/label/ (a Popen)."""
    d = os.path.join(out_dir, label)
    os.makedirs(d, exist_ok=True)
    lib = os.path.join(d, "libnoisy_update.so")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", lib,
           os.path.join(src_dir, "noisy_update.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


# `noisy_sgd`'s signature before its key moved to device memory: the key
# as two uint32 arguments (lo32, hi32) in place of one pointer
HOST_KEY_SGD = [*_build.SIGNATURES["noisy_update"]["noisy_sgd"][:8],
                ctypes.c_uint32, ctypes.c_uint32,
                *_build.SIGNATURES["noisy_update"]["noisy_sgd"][9:]]


def load(lib: str, src_dir: str) -> ctypes.CDLL:
    """The library, its `noisy_sgd` bound by the signature its source
    declares (`host_key`: the key as two words, before it was read from
    device memory)."""
    so = ctypes.CDLL(lib)
    with open(os.path.join(src_dir, "noisy_update.cu")) as f:
        so.host_key = "const void* key, uint32_t leaf" not in f.read()
    for fn, argtypes in _build.SIGNATURES["noisy_update"].items():
        if fn == "noisy_sgd" and so.host_key:
            argtypes = HOST_KEY_SGD
        getattr(so, fn).argtypes = argtypes
        getattr(so, fn).restype = ctypes.c_int
    return so


def ptxas_table(log: str) -> dict:
    """{instance: {registers, spill_store_bytes, spill_load_bytes,
    smem_bytes}} from a ptxas -v log."""
    found, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(SM.NOISY_PATTERN, line)
            entry = SM.noisy_name(m) if m else None
            if entry:
                found[entry] = {}
        elif entry and "spill stores" in line:
            found[entry]["spill_store_bytes"] = int(re.search(
                r"(\d+) bytes spill stores", line)[1])
            found[entry]["spill_load_bytes"] = int(re.search(
                r"(\d+) bytes spill loads", line)[1])
        elif entry and "Used" in line:
            found[entry]["registers"] = int(re.search(
                r"Used (\d+) registers", line)[1])
            smem = re.search(r"(\d+) bytes smem", line)
            found[entry]["smem_bytes"] = int(smem[1]) if smem else 0
    return found


def sgd(lib, out, p, g, shift, scale, z, mode, part):
    """lib's noisy_sgd of one part: out from p, g (and z, mode 1)."""
    nd, st, off, ln = NU._geometry(part)
    key_t = P.seed_tensor(SEED, p.device)   # held past the launch
    key = P.key_of(SEED) if lib.host_key else (key_t.data_ptr(),)
    _build.check(lib.noisy_sgd(
        out.data_ptr(), p.data_ptr(), g.data_ptr(), shift.data_ptr(),
        scale.data_ptr(), None if z is None else z.data_ptr(), ALPHA, mode,
        *key, LEAF, nd, st, off, ln, _build.DTYPE_CODES[p.dtype],
        torch.cuda.current_stream().cuda_stream), "noisy_sgd")
    return out


def trunc(lib, out, part):
    nd, st, off, ln = NU._geometry(part)
    k0, k1 = P.key_of(SEED)
    _build.check(lib.counter_trunc_normal(
        out.data_ptr(), 0.02, P.TN_LO, P.TN_WIDTH, k0, k1, LEAF, nd, st,
        off, ln, _build.DTYPE_CODES[out.dtype],
        torch.cuda.current_stream().cuda_stream), "counter_trunc_normal")
    return out


def parts_of(full, cuts):
    """Every part of a leaf of shape `full` split by {dim: ways}."""
    from itertools import product

    class Ax:
        def __init__(self, index, size):
            self.index, self.size = index, size
    dims = sorted(cuts)
    return [P.split_part(full, [(d, Ax(i, cuts[d])) for d, i in zip(dims, idx)])
            for idx in product(*(range(cuts[d]) for d in dims))]


def cases():
    """(name, [parts], element offset of p and g in their buffers)."""
    out = [("embedding", [P.Part.whole(EMB)], 0),
           ("stacked_wk", [P.Part.whole(WK)], 0),
           ("misaligned_16x36x20_in_16x4", parts_of((16, 36, 20),
                                                    {0: 16, 2: 4}), 0),
           ("rows_of_64_wk_in_16", parts_of(WK, {2: 16}), 0),
           ("big_leaf_in_16x16", parts_of(BIG, dict(enumerate(BIG_RANKS))),
            0),
           # three dims after merging: the row table
           ("wk_in_2x16_three_dims", parts_of(WK, {1: 2, 2: 16}), 0),
           ("three_dims_rows_of_12", [P.Part((6, 40, 24), (1, 8, 4),
                                             (4, 20, 12))], 0)]
    for o in (1, 2, 3):
        out.append((f"row_start_j_mod4_{o}",
                    [P.Part((301, 40), (0, o), (301, 20))], 0))
    for n in (4, 12, 20):
        out.append((f"rows_of_{n}", parts_of((257, 3 * n), {1: 3}), 0))
    out.append(("odd_offset_pointers", [P.Part.whole((1000, 37)),
                                        P.Part((64, 1024), (3, 8), (50, 1000))],
                1))
    out.append(("tail_under_one_vector", [P.Part.whole((4099,)),
                                          P.Part.whole((3,))], 0))
    return out


def bitwise(libs, out_dir) -> bool:
    """Old and new bit for bit on every case, mode and dtype."""
    old, new = libs["old"], libs["new"]
    ok_all = True
    shift_of = {dt: torch.tensor(1e-4, device="cuda").to(dt)
                for dt in (torch.float32, torch.bfloat16)}
    scale = torch.tensor(1e-2, device="cuda")
    for name, parts, shift_el in cases():
        numel = max(p.numel for p in parts) + shift_el
        res = {}
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator("cuda").manual_seed(3)
            pb = (torch.randn(numel, generator=gen, device="cuda") * 0.02
                  ).to(dt)
            gb = (torch.randn(numel, generator=gen, device="cuda") * 1e-3
                  ).to(dt)
            zb = torch.randn(numel, generator=gen, device="cuda")
            view = torch.int32 if dt == torch.float32 else torch.int16
            eq = {"none": True, "given": True, "drawn": True, "trunc": True}
            for part in parts:
                n = part.numel
                p = pb[shift_el:shift_el + n].view(part.shape)
                g = gb[shift_el:shift_el + n].view(part.shape)
                z = zb[:n].view(part.shape)
                for mode, m in NU.MODES.items():
                    o = [sgd(lib, torch.empty_like(p), p, g, shift_of[dt],
                             scale, z if m == 1 else None, m, part)
                         for lib in (old, new)]
                    eq[mode] &= torch.equal(o[0].view(view), o[1].view(view))
                t = [trunc(lib, torch.empty(part.shape, dtype=dt,
                                            device="cuda"), part)
                     for lib in (old, new)]
                eq["trunc"] &= torch.equal(t[0].view(view), t[1].view(view))
            res[str(dt)[6:]] = eq
            ok_all &= all(eq.values())
            del pb, gb, zb
        torch.cuda.empty_cache()
        emit(out_dir, "bitwise", case=name, parts=len(parts),
             shapes=sorted({str(list(p.shape)) for p in parts})[:3],
             element_offset=shift_el, equal=res)
    return ok_all


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True)
    ap.add_argument("--new", default=str(_build.CSRC))
    ap.add_argument("--only", choices=("old", "new"))
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "noisy_yardstick"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("noisy_update_yardstick: needs a CUDA card", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit(args.out, "device", nvidia_smi=smi,
         kind=torch.cuda.get_device_name(0), torch=torch.__version__,
         cuda=torch.version.cuda)
    labels = [args.only] if args.only else ["old", "new"]
    srcs = {"old": args.old, "new": args.new}
    procs = {lb: build(lb, srcs[lb], args.out) for lb in labels}
    libs, mixes = {}, {}
    for lb, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(args.out, f"{lb}.ptxas.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            emit(args.out, "build_failed", version=lb, log=log[-4000:])
            return 1
        emit(args.out, "ptxas", version=lb, kernels=ptxas_table(log))
        text = SM.sass_of(lib)
        with open(os.path.join(args.out, f"{lb}.sass"), "w") as f:
            f.write(text)
        mix = SM.kernel_mixes(text, SM.NOISY_PATTERN, SM.noisy_name)
        mixes[lb] = {k: SM.summary(v, SM.noisy_esize(k))
                     for k, v in mix.items()}
        funcs = SM.parse_sass(text)
        reductions = {SM.noisy_name(re.search(SM.NOISY_PATTERN, fn)):
                      sum(TRIG_THRESHOLD in i[3] for i in ins)
                      for fn, ins in funcs.items()
                      if re.search(SM.NOISY_PATTERN, fn)}
        emit(args.out, "sass", version=lb, kernels=mixes[lb],
             trig_reductions=reductions)
        libs[lb] = load(lib, srcs[lb])
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # the clock under load: the bf16 update, drawn, at the embedding
    lb0 = labels[-1]
    gen = torch.Generator("cuda").manual_seed(8)
    p = (torch.randn(EMB, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    g = (torch.randn(EMB, generator=gen, device="cuda") * 1e-3).to(
        torch.bfloat16)
    sh = torch.tensor(1e-4, device="cuda").to(torch.bfloat16)
    sc = torch.tensor(1e-2, device="cuda")
    out = torch.empty_like(p)
    whole = P.Part.whole(EMB)
    clocks = SM.sm_clock_under_load(
        lambda: sgd(libs[lb0], out, p, g, sh, sc, None, 2, whole),
        torch.cuda.synchronize)
    clock = SM.median(clocks)
    emit(args.out, "clock", version=lb0, sm_mhz=clocks, median_mhz=clock)
    del p, g, out
    torch.cuda.empty_cache()

    if "new" in libs:
        d = os.path.join(args.out, "sincos")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "sincos.cu"), "w") as f:
            f.write(SINCOS_SRC)
        so = os.path.join(d, "libsincos.so")
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(d, "sincos.cu")], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(so)
        lib.sincos_check_all.argtypes = [ctypes.c_void_p]
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        _build.check(lib.sincos_check_all(bad.data_ptr()), "sincos_check")
        emit(args.out, "sincos", angles=2 ** 23, mismatches=int(bad.item()))

    ok = True
    if len(libs) == 2:
        ok = bitwise(libs, args.out)
        emit(args.out, "bitwise_all", equal=ok)

    if args.no_timing:
        print(json.dumps({"ok": ok}), flush=True)
        return 0 if ok else 1
    # timings: each row in turns old, new, new, old
    order = ["old", "new", "new", "old"] if len(libs) == 2 else labels * 2
    rows = [("noisy_sgd", "embedding", EMB, {}, torch.bfloat16, "drawn"),
            ("noisy_sgd", "stacked_wk", WK, {}, torch.bfloat16, "drawn"),
            ("noisy_sgd", "rows_of_64", WK, {2: 16}, torch.bfloat16,
             "drawn"),
            ("noisy_sgd", "rows_of_64_as_one_row", (36 * 2560 * 64,), {},
             torch.bfloat16, "drawn"),
            ("noisy_sgd", "embedding", EMB, {}, torch.bfloat16, "given"),
            ("noisy_sgd", "embedding", EMB, {}, torch.bfloat16, "none"),
            ("noisy_sgd", "embedding", EMB, {}, torch.float32, "drawn"),
            ("counter_trunc_normal", "embedding", EMB, {}, torch.bfloat16,
             None),
            ("counter_trunc_normal", "stacked_wk", WK, {}, torch.bfloat16,
             None),
            ("counter_trunc_normal", "rows_of_64", WK, {2: 16},
             torch.bfloat16, None)]
    for kernel, label, full, cuts, dt, mode in rows:
        part = parts_of(full, cuts)[0] if cuts else P.Part.whole(full)
        gen = torch.Generator("cuda").manual_seed(9)
        esize = torch.finfo(dt).bits // 8
        inst = (f"noisy_sgd_kernel<{'f32' if esize == 4 else 'bf16'}, "
                f"{NU.MODES[mode]}>" if kernel == "noisy_sgd" else
                f"counter_trunc_normal_kernel<"
                f"{'f32' if esize == 4 else 'bf16'}>")
        if kernel == "noisy_sgd":
            p = (torch.randn(part.shape, generator=gen, device="cuda")
                 * 0.02).to(dt)
            g = (torch.randn(part.shape, generator=gen, device="cuda")
                 * 1e-3).to(dt)
            z = (torch.randn(part.shape, generator=gen, device="cuda")
                 if mode == "given" else None)
            sh = torch.tensor(1e-4, device="cuda").to(dt)
            out = torch.empty_like(p)
            fns = {lb: (lambda lib=libs[lb]: sgd(lib, out, p, g, sh, sc, z,
                                                 NU.MODES[mode], part))
                   for lb in libs}
            nbytes = NU.bytes_flops(part, esize, mode)[0]
        else:
            out = torch.empty(part.shape, dtype=dt, device="cuda")
            fns = {lb: (lambda lib=libs[lb]: trunc(lib, out, part))
                   for lb in libs}
            nbytes = NU.trunc_bytes_flops(part, esize)[0]
        times = {lb: [] for lb in libs}
        clocks = {lb: [] for lb in libs}
        for lb in order:
            smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, text=True)
            times[lb].append(time_ms(torch, fns[lb], iters=100))
            smi.terminate()
            read = [ln.split(",") for ln in smi.communicate()[0].split("\n")
                    if ln.count(",") == 1]
            clocks[lb].append([[float(a), float(b)] for a, b in read])
        row = {"kernel": kernel, "case": label, "shape": list(part.shape),
               "dtype": str(dt)[6:], "mode": mode, "ms": times,
               "sm_mhz_watts": clocks,
               "mean_ms": {lb: sum(v) / len(v) for lb, v in times.items()},
               "bytes": nbytes,
               "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if clock:
            row["issue_bound_ms"] = {
                lb: SM.issue_bound_ms(mixes[lb][inst]["hot"][
                    "cycles_per_element"], part.numel, sms, clock)
                for lb in libs if "hot" in mixes[lb].get(inst, {})}
            row["clock_mhz"] = clock
        if kernel == "counter_trunc_normal" and dt == torch.bfloat16:
            t = torch.empty(part.shape, dtype=dt, device="cuda")
            row["library_ms"] = time_ms(
                torch, lambda: torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0,
                                                           2.0))
            row["library"] = "torch.nn.init.trunc_normal_(t, 0, 1, -2, 2)"
            del t
        emit(args.out, "timing", **row)
        del out, fns
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
