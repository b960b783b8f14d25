"""A kernel's instruction mix from its SASS, and the issue-rate bound it sets.

    python tools/sass_mix.py LIB.so

`cuobjdump -sass` of a built library is split into functions; each
function into basic blocks (leaders: the first instruction, branch targets
and the instruction after a branch, EXIT or RET).  A loop is a backward
branch's span.  For each loop that stores (STG), the *hot path* is the
shortest path, in instructions, from the loop's head to its backward branch
that passes every block holding the loop's widest stores, on the loop's
forward edges: the common path of a kernel whose slow branches (a range
reduction's Payne-Hanek path, a square root's special cases, a head or a
tail) only add instructions; a block that calls a subroutine is never on
it.  Its elements are the bytes those stores write
over the element size; its mix, per element, sets the issue-rate bound:

    cycles per element on one SM = max over units of (warp instructions on
    that unit) / (the unit's warp instructions a clock)

with the units and rates of compute capability 9.0 (the CUDA C++
Programming Guide's throughput table, operations a clock per SM: 32-bit
floating add / multiply / FMA 128; 32-bit integer add, multiply, compare,
logic and shift 64; MUFU 16; type conversions 16), one warp instruction a
clock issued per SM partition (4 per SM), IMAD on the FMA pipe's heavy half
(so IMAD + FP32 <= 128 a clock and IMAD <= 64), and loads and stores at 32
a clock.  F2FP (the f32-to-bf16 pack) is counted as a conversion, the
conservative reading.  Predicated-off instructions are counted: the issue
slot is spent.  The bound is the mix's, not a measurement: it says how fast
the instructions could issue, not that they do.  Imports no torch.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter

# operations a clock per SM, by unit
RATES = {"issue": 128, "fma": 128, "imad": 64, "alu": 64, "xu": 16,
         "lsu": 32}
FMA = {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I", "HFMA2",
       "HADD2", "HMUL2", "FSWZADD", "FCHK"}
IMAD = {"IMAD", "IMUL", "IMUL32I", "IMAD32I", "IDP", "IMADSP"}
ALU = {"IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL",
       "SHR", "ISETP", "FSETP", "FSEL", "SEL", "FMNMX", "IMNMX", "VIMNMX",
       "LEA", "PRMT", "MOV", "MOV32I", "PLOP3", "P2R", "R2P", "IABS",
       "BMSK", "SGXT", "I2FP", "F2IP", "CSETP", "ISCADD", "HSETP2", "HMNMX2",
       "FMNMX3"}
XU = {"MUFU", "I2F", "F2I", "F2F", "FRND", "F2FP", "POPC", "FLO", "BREV"}
LSU = {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDL", "STL", "ATOM", "ATOMG",
       "ATOMS", "RED", "LDGSTS", "LDSM", "SHFL", "LDC", "ULDC"}
CONTROL = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BSSY", "BSYNC",
           "WARPSYNC", "NOP", "BAR", "DEPBAR", "YIELD", "BREAK", "BPT",
           "MEMBAR", "ERRBAR", "CCTL", "KILL", "NANOSLEEP", "ACQBULK"}
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def unit(op: str) -> str:
    """The unit an opcode (its name before the first '.') issues to."""
    if op in FMA:
        return "fma"
    if op in IMAD:
        return "imad"
    if op in ALU:
        return "alu"
    if op in XU:
        return "xu"
    if op in LSU:
        return "lsu"
    if op in CONTROL:
        return "control"
    if op.startswith("U") or op in ("S2R", "S2UR", "CS2R", "R2UR"):
        return "uniform"
    return "other"


def parse_sass(text: str) -> dict:
    """{function name: [(address, predicate, opcode with modifiers,
    operands)]} of a `cuobjdump -sass` listing."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m[1], [])
            continue
        m = _INSTR.search(line)
        if m is None or cur is None:
            continue
        addr, body = int(m[1], 16), m[2].strip()
        pred = ""
        if body.startswith("@"):
            pred, _, body = body.partition(" ")
        op, _, args = body.partition(" ")
        cur.append((addr, pred, op, args.strip()))
    return funcs


def _branch(ins):
    """(is a branch, its target address or None, conditional)."""
    _, pred, op, args = ins
    base = op.split(".")[0]
    if base not in ("BRA", "BRX", "JMP"):
        return False, None, False
    m = _TARGET.search(args.split(",")[-1])
    cond = (pred not in ("", "@PT") or op.startswith("BRA.DIV")
            or bool(re.match(r"!?U?P\d", args)))
    return True, (int(m[1], 16) if m else None), cond


def _ends(ins) -> bool:
    """Whether control never falls through past this instruction."""
    _, pred, op, _ = ins
    base = op.split(".")[0]
    if base in ("EXIT", "RET", "BRX", "JMX", "KILL"):
        return pred in ("", "@PT")
    is_br, _, cond = _branch(ins)
    return is_br and not cond


def blocks(instrs) -> list:
    """Basic blocks: [(first address, [instructions], [successor first
    addresses])] in address order."""
    if not instrs:
        return []
    addrs = [i[0] for i in instrs]
    leaders = {addrs[0]}
    for k, ins in enumerate(instrs):
        is_br, tgt, _ = _branch(ins)
        if is_br and tgt is not None:
            leaders.add(tgt)
        if (is_br or _ends(ins)) and k + 1 < len(instrs):
            leaders.add(addrs[k + 1])
    out, cur = [], []
    for k, ins in enumerate(instrs):
        if ins[0] in leaders and cur:
            out.append(cur)
            cur = []
        cur.append(ins)
    out.append(cur)
    firsts = [b[0][0] for b in out]
    result = []
    for n, b in enumerate(out):
        last = b[-1]
        succ = []
        is_br, tgt, _ = _branch(last)
        if is_br and tgt is not None:
            succ.append(tgt)
        if not _ends(last) and n + 1 < len(out):
            succ.append(firsts[n + 1])
        result.append((firsts[n], b, succ))
    return result


def _store_bytes(op: str) -> int:
    """Bytes a thread writes with one STG of these modifiers."""
    for mod, nb in ((".128", 16), (".64", 8), (".U16", 2), (".S16", 2),
                    (".U8", 1), (".S8", 1)):
        if mod in op:
            return nb
    return 4


def hot_loops(instrs) -> list:
    """For every loop that holds a store: {"head", "end", "path": [block
    first addresses], "mix": Counter of opcodes on the hot path,
    "store_bytes": bytes the path's widest stores write a thread}."""
    bl = blocks(instrs)
    index = {b[0]: n for n, b in enumerate(bl)}
    loops = []
    for n, (first, body, _) in enumerate(bl):
        is_br, tgt, _ = _branch(body[-1])
        if not (is_br and tgt is not None and tgt <= body[-1][0]
                and tgt in index):
            continue
        lo, hi = index[tgt], n
        widest = max((_store_bytes(i[2]) for b in bl[lo:hi + 1]
                      for i in b[1] if i[2].startswith("STG")), default=0)
        if widest == 0:
            continue
        need = [k for k in range(lo, hi + 1) if any(
            i[2].startswith("STG") and _store_bytes(i[2]) == widest
            for i in bl[k][1])]
        path = _shortest_through(bl, index, lo, hi, need)
        if path is None:
            continue
        mix = Counter(i[2] for k in path for i in bl[k][1])
        nbytes = sum(_store_bytes(i[2]) for k in path for i in bl[k][1]
                     if i[2].startswith("STG") and _store_bytes(i[2])
                     == widest)
        loops.append({"head": bl[lo][0], "end": body[-1][0],
                      "path": [bl[k][0] for k in path], "mix": mix,
                      "store_bytes": nbytes, "store_width": widest,
                      "instructions": sum(mix.values())})
    return loops


def _weight(instrs) -> int:
    """A block's instructions, or far more where it calls a subroutine (a
    division's or a square root's slow path): the callee is not counted,
    so the call's few instructions would look cheaper than the inline
    fast path beside it."""
    return len(instrs) + 10000 * any(i[2].startswith("CALL")
                                     for i in instrs)


def _shortest_through(bl, index, lo, hi, need):
    """Block indices of the shortest forward path lo -> hi (weights: each
    block's instruction count) through every block of `need`, or None."""
    stops = [lo] + [k for k in need if k != lo]
    if stops[-1] != hi:
        stops.append(hi)
    path = [lo]
    for a, b in zip(stops, stops[1:]):
        best = {a: (0, None)}
        for k in range(a, b + 1):
            if k not in best:
                continue
            for s in bl[k][2]:
                t = index.get(s)
                if t is None or t <= k or t > b:
                    continue
                w = best[k][0] + _weight(bl[t][1])
                if t not in best or w < best[t][0]:
                    best[t] = (w, k)
        if b not in best:
            return None
        seg, k = [], b
        while k != a:
            seg.append(k)
            k = best[k][1]
        path.extend(reversed(seg))
    return path


def units(mix: Counter) -> Counter:
    """Warp instructions by unit, and their total under "issue"."""
    out = Counter()
    for op, n in mix.items():
        out[unit(op.split(".")[0])] += n
        out["issue"] += n
    return out


def cycles_per_element(mix: Counter, elements: float) -> dict:
    """{"per_element": instructions by unit per element, "cycles": SM
    clocks per element by limit, "bound_by", "cycles_per_element"} of a
    hot path that handles `elements` elements a thread."""
    u = units(mix)
    per = {k: v / elements for k, v in u.items()}
    # one thread's instruction is 1/32 of a warp instruction; an SM issues
    # RATES[k] thread-operations of unit k a clock
    cyc = {"issue": per["issue"] / RATES["issue"],
           "fma": (per.get("fma", 0) + per.get("imad", 0)) / RATES["fma"],
           "imad": per.get("imad", 0) / RATES["imad"],
           "alu": per.get("alu", 0) / RATES["alu"],
           "xu": per.get("xu", 0) / RATES["xu"],
           "lsu": per.get("lsu", 0) / RATES["lsu"]}
    by = max(cyc, key=cyc.get)
    return {"per_element": per, "cycles": cyc, "bound_by": by,
            "cycles_per_element": cyc[by]}


def issue_bound_ms(cpe: float, elements: int, sms: int, clock_mhz: float
                   ) -> float:
    """The least ms `elements` take at `cpe` SM clocks each, spread over
    `sms` SMs at `clock_mhz`."""
    return elements * cpe / (sms * clock_mhz * 1e6) * 1e3


def cuobjdump() -> str:
    """Path of cuobjdump: beside nvcc ($CUDA_HOME, /usr/local/cuda), or on
    $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "cuobjdump")):
            return os.path.join(root, "bin", "cuobjdump")
    found = shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found (the CUDA toolkit's bin)")
    return found


def sass_of(lib: str) -> str:
    return subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout


def kernel_mixes(text: str, pattern: str, name_of) -> dict:
    """{readable name: {"static": Counter of the whole function's opcodes,
    "loops": hot_loops(...)}} of the functions whose mangled name matches
    the regex `pattern`; `name_of(match)` gives the readable name."""
    out = {}
    for fn, instrs in parse_sass(text).items():
        m = re.search(pattern, fn)
        if m:
            out[name_of(m)] = {"static": Counter(i[2] for i in instrs),
                               "loops": hot_loops(instrs)}
    return out


# noisy_update.cu's kernels by their mangled names
NOISY_PATTERN = (r"(noisy_sgd_kernel|counter_trunc_normal_kernel)"
                 r"I(f|13__nv_bfloat16)(?:Li(\d)E)?")


def noisy_name(m) -> str:
    t = "f32" if m[2] == "f" else "bf16"
    return f"{m[1]}<{t}{', ' + m[3] if m[3] else ''}>"


def noisy_esize(name: str) -> int:
    return 4 if "<f32" in name else 2


def best_loop(entry: dict, esize: int):
    """(the hot loop with the fewest instructions an element among those
    with the widest stores, its elements a thread) of one kernel, or (None,
    0): a kernel's vector path before its scalar heads and tails."""
    best, key = None, None
    for loop in entry["loops"]:
        n = loop["store_bytes"] / esize
        k = (-loop["store_width"], loop["instructions"] / n) if n else None
        if k and (best is None or k < key):
            best, key = loop, k
    return best, (best["store_bytes"] / esize if best else 0)


def summary(entry: dict, esize: int) -> dict:
    """The JSON-ready mix of one kernel: its static size, every hot loop's
    size and elements, and the cheapest loop's per-element units and SM
    clocks per element."""
    loop, n = best_loop(entry, esize)
    out = {"static_instructions": sum(entry["static"].values()),
           "loops": [{"head": hex(x["head"]), "end": hex(x["end"]),
                      "instructions": x["instructions"],
                      "elements": x["store_bytes"] / esize,
                      "store_width": x["store_width"]}
                     for x in entry["loops"]]}
    if loop is not None:
        ops = Counter()
        for op, k in loop["mix"].items():
            ops[op.split(".")[0]] += k
        out["hot"] = {"head": hex(loop["head"]), "elements": n,
                      "instructions": loop["instructions"],
                      "opcodes": {k: v / n for k, v in sorted(ops.items())},
                      **cycles_per_element(loop["mix"], n)}
    return out


def sm_clock_under_load(fn, sync, seconds: float = 2.0) -> list:
    """SM clocks (MHz) `nvidia-smi -q -d CLOCK` reads while fn() runs back
    to back for `seconds` (sync() waits for the card)."""
    readings, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            txt = subprocess.run(["nvidia-smi", "-q", "-d", "CLOCK"],
                                 capture_output=True, text=True).stdout
            # the first "Clocks" section is the current one
            sec = txt.split("Clocks\n", 1)[-1]
            m = re.search(r"SM\s*:\s*(\d+)\s*MHz", sec)
            if m:
                readings.append(int(m[1]))
            time.sleep(0.2)

    fn()
    sync()
    th = threading.Thread(target=sample)
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        sync()
    stop.set()
    th.join()
    return readings


def median(xs):
    return sorted(xs)[len(xs) // 2] if xs else None


def main(argv) -> int:
    """Each noisy_update kernel instance of the library argv[0]: its
    summary, one line each."""
    text = sass_of(argv[0])
    for name, entry in kernel_mixes(text, NOISY_PATTERN, noisy_name).items():
        print(name, summary(entry, noisy_esize(name)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
