"""Compiled execution: the port's counterpart of the reference's `jax.jit`
and `lax.scan`.

The reference compiles every hot loop: the serve decode step
(`repro/launch/serve.py:55`), the FLOA train step with its seed passed as
a device value (`repro/launch/train.py:89-93`) and a chunk of sweep rounds
(`repro/fl/sweep.py`'s `lax.scan`).  The port's entry points capture their
steady-state step as a CUDA graph and replay it (`StepGraph`), so a step
costs one graph launch on the host instead of hundreds or thousands of
kernel launches:

  - `launch/serve.py::serve`: the decode step;
  - `launch/train.py`: the FLOA train step on one device (`compile_step`);
  - `fl/sweep.py::SweepEngine.run`: one round of the flat-state plan on
    one device.

A `StepGraph` holds a callable's static input buffers.  The arguments it
is told to hold by reference (`static`: the weights, the caches, the
sweep's state) are those very tensors, which every call must pass again;
every other tensor argument is copied into a buffer of its own at each
call.  Non-tensor arguments are baked into the graph: a call with other
ones raises.  The first call runs the callable eagerly on a side stream
(the warm-up: kernel libraries are built, lazy state is made, and its
result is the call's); the second captures it once with
`torch.cuda.graph`, with every `torch.Generator` it draws from registered
(`CUDAGraph.register_generator_state`, so each replay advances a
generator as an eager call would), then replays it; every later call
copies its inputs in and replays.  Outputs are the graph's static
tensors, which the next call overwrites: a caller clones what it keeps.
Values do not change: the graph runs the same kernels on the same bytes
as the eager call, so graphed equals eager bitwise.

The kernel wrappers count their launches in Python (`kernels/ops.py`),
which a replay never runs.  The capture's counts are therefore taken back
(a capture launches nothing) and added again at every replay, so that
`ops.launch_counts()` and `ops.launch_shapes()` after a graphed run equal
the eager run's.

On the CPU a `StepGraph` runs the same copy-in / call / copy-out path
without a capture (the outputs copied into static buffers of their own),
so the CPU tests exercise everything but the capture itself.  On the
card a capture that fails raises: nothing falls back to eager quietly.
`disable_graphs()` is the counterpart of `jax.disable_jit()`: inside it
every `StepGraph` calls its function directly on the caller's arguments,
which is how the tests and `chip_smoke.py` run the eager route.  Captures and replays are
counted in `totals()`.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

from repro_torch.kernels import ops

Tensor = torch.Tensor

_ENABLED = [True]
_TOTALS = {"captures": 0, "replays": 0, "capture_s": 0.0}


@contextlib.contextmanager
def disable_graphs() -> Iterator[None]:
    """Within the block every `StepGraph` runs its eager function: the
    counterpart of `jax.disable_jit()`."""
    prev = _ENABLED[0]
    _ENABLED[0] = False
    try:
        yield
    finally:
        _ENABLED[0] = prev


def graphs_enabled() -> bool:
    """False inside `disable_graphs()`."""
    return _ENABLED[0]


def totals() -> Dict[str, float]:
    """Captures, replays and the host seconds of the captures (warm-up
    excluded, instantiation included) of every `StepGraph` since
    `reset_totals`."""
    return dict(_TOTALS)


def reset_totals() -> None:
    for k in _TOTALS:
        _TOTALS[k] = 0 if k != "capture_s" else 0.0


# ---------------------------------------------------------------- trees

_TENSOR = object()


def _flatten(x, leaves: List[Any]):
    """The spec of `x` (dicts with sorted keys, lists, tuples), with its
    tensors appended to `leaves` and every other value kept in the spec."""
    if isinstance(x, Tensor):
        leaves.append(x)
        return _TENSOR
    if isinstance(x, dict):
        return ("dict", tuple((k, _flatten(x[k], leaves)) for k in sorted(x)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_flatten(v, leaves) for v in x))
    return ("value", x)


def _unflatten(spec, it: Iterator[Tensor]):
    if spec is _TENSOR:
        return next(it)
    kind, body = spec
    if kind == "dict":
        return {k: _unflatten(v, it) for k, v in body}
    if kind in ("list", "tuple"):
        seq = [_unflatten(v, it) for v in body]
        return seq if kind == "list" else tuple(seq)
    return body


def _same(a: Tensor, b: Tensor) -> bool:
    """Whether b is the very buffer a: the same storage, place and layout."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype
            and a.device == b.device)


# ---------------------------------------------------------------- counts

def _snapshot():
    return (ops.launch_counts(), {k: collections.Counter(v) for k, v in
                                  ops.launch_shapes().items()})


def _restore(snap) -> None:
    counts, shapes = snap
    for name, fn in ops.KERNELS.items():
        fn.launches = counts[name]
        if name in shapes:
            fn.shapes.clear()
            fn.shapes.update(shapes[name])


def _delta(before, after):
    counts = {k: after[0][k] - before[0][k] for k in after[0]}
    shapes = {k: after[1][k] - before[1][k] for k in after[1]}
    return counts, shapes


def _add(delta) -> None:
    counts, shapes = delta
    for name, fn in ops.KERNELS.items():
        fn.launches += counts[name]
        if name in shapes:
            fn.shapes.update(shapes[name])


# ---------------------------------------------------------------- graphs

class StepGraph:
    """`fn(*args)` captured once as a CUDA graph and replayed (module
    docstring).

    static: the positions of the arguments whose tensors the graph holds
    by reference (read, and written in place where fn writes them): every
    call passes those same tensors, or raises.  The other tensor arguments
    are copied into buffers the graph owns.  generators: every
    `torch.Generator` fn draws from.  Inside `disable_graphs()` a call is
    fn on the caller's arguments.  `captures` and `replays` count this
    graph's."""

    def __init__(self, fn: Callable, *, static: Sequence[int] = (),
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.static = frozenset(static)
        self.generators = list(generators)
        self.captures = 0
        self.replays = 0
        self._spec = None
        self._held: List[bool] = []
        self._buffers: List[Tensor] = []
        self._out_spec = None
        self._outputs: Optional[List[Tensor]] = None
        self._graph = None
        self._warm = False
        self._delta = None

    def __call__(self, *args):
        if not _ENABLED[0]:
            return self.fn(*args)
        inputs = self._copy_in(args)
        if not inputs or inputs[0].device.type != "cuda":
            return self._call_plain()
        if not self._warm:
            return self._warm_up()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.replays += 1
        _TOTALS["replays"] += 1
        _add(self._delta)
        return self._out_tree()

    # the steps of a call

    def _args(self):
        return _unflatten(self._spec, iter(self._buffers))

    def _copy_in(self, args) -> List[Tensor]:
        """Bind the buffers at the first call; later, copy each copied
        argument in and check each held one."""
        leaves: List[Tensor] = []
        held: List[bool] = []
        specs = []
        for i, a in enumerate(args):
            n = len(leaves)
            specs.append(_flatten(a, leaves))
            held += [i in self.static] * (len(leaves) - n)
        spec = ("tuple", tuple(specs))
        if self._spec is None:
            self._spec, self._held = spec, held
            self._buffers = [x if h else x.detach().clone()
                             for x, h in zip(leaves, held)]
            return self._buffers
        if spec != self._spec:
            raise ValueError(
                "StepGraph: the call's arguments differ in structure or in "
                "a non-tensor value from the captured call's; build another "
                "graph for them")
        for k, (x, buf, h) in enumerate(zip(leaves, self._buffers,
                                            self._held)):
            if h:
                if not _same(buf, x):
                    raise ValueError(
                        f"StepGraph: argument tensor {k} is held by "
                        f"reference, and this call passes another tensor "
                        f"than the first call's")
            elif not _same(buf, x):
                if x.shape != buf.shape or x.dtype != buf.dtype:
                    raise ValueError(
                        f"StepGraph: argument tensor {k} is "
                        f"{x.dtype} {tuple(x.shape)}, the graph's buffer "
                        f"{buf.dtype} {tuple(buf.shape)}")
                buf.copy_(x)
        return self._buffers

    def _out_tree(self):
        return _unflatten(self._out_spec, iter(self._outputs))

    def _call_plain(self):
        """The CPU's call: fn on the buffers, its outputs copied into
        static buffers of their own (an output that is a held input
        passes through)."""
        out = self.fn(*self._args())
        leaves: List[Tensor] = []
        spec = _flatten(out, leaves)
        held = [b for b, h in zip(self._buffers, self._held) if h]
        if self._outputs is None:
            self._out_spec = spec
            self._outputs = [
                x if any(x is b for b in held) else x.detach().clone()
                for x in leaves]
            return self._out_tree()
        if spec != self._out_spec:
            raise ValueError("StepGraph: the step's outputs changed "
                             "structure between calls")
        for buf, x in zip(self._outputs, leaves):
            if buf is not x:
                buf.copy_(x)
        return self._out_tree()

    def _warm_up(self):
        """The first call, eager on a side stream (its result is the
        call's): libraries built, lazy state made before the capture."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = self.fn(*self._args())
        torch.cuda.current_stream().wait_stream(side)
        self._warm = True
        return out

    def _capture(self) -> None:
        """Capture fn once on the static buffers; the capture's launch
        counts become the replay's."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = _snapshot()
        with torch.cuda.graph(graph):
            out = self.fn(*self._args())
        _TOTALS["capture_s"] += time.perf_counter() - t0
        self._delta = _delta(before, _snapshot())
        _restore(before)
        leaves: List[Tensor] = []
        self._out_spec = _flatten(out, leaves)
        self._outputs = leaves
        self._graph = graph
        self.captures += 1
        _TOTALS["captures"] += 1
