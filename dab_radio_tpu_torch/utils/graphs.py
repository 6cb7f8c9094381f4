"""Captured CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs each device step as one compiled program, one program
for each set of input shapes (``dab_radio_tpu/parallel/mesh.py``'s jitted
round, ``models/fused_fleet.py``'s ``_pack``, ``models/demodulator.py``'s
frame step and scan). Eager PyTorch issues the same step as hundreds of
launches, each tens of microseconds of host time. ``CapturedProgram`` gives
the port the same shape of execution: on a CUDA device a pure function of
tensors is captured once for each input signature as a CUDA graph
(``torch.cuda.CUDAGraph``) and replayed, one launch of the host a call.

The contract, for ``program = CapturedProgram(fn, device, state=...)``:

* ``fn`` is a pure function of its arguments: it reads no device value on
  the host, makes no tensor from host data, and changes none of its
  arguments in place. Arguments are tensors, numpy arrays, or nested
  tuples, lists, dicts and named tuples of them; other values (ints, None,
  strings) are baked into the program as constants.
* The cache key is the shape and dtype of every tensor or array argument,
  the value of every other one (a ``None`` is its own key) and the
  arguments' nesting. Flags that ``fn`` closes over belong to ``fn``: a
  program wraps one function.
* The first call for a key copies the arguments into static buffers and
  runs ``fn`` on them eagerly, on a side stream: that run is the warm-up
  (it makes cuFFT's plans and loads the kernels' libraries before any
  capture) and its results are the call's results. The key's graph is
  captured right after it, with Python's garbage collector off (a
  collection there could free another program's graph, which invalidates
  the capture); a failed capture raises with CUDA's error, and nothing
  falls back to the eager run. From the second call on, the
  arguments are copied into the static buffers (a numpy array through a
  pinned staging buffer, without blocking the host) and the graph is
  replayed.
* Outputs of a replay are the graph's static buffers: valid until the
  program's next call, whatever its key. A caller that keeps an output
  longer copies it.
* With ``state`` (a tensor or a nested tuple of them, such as a carry and
  a history), ``fn(state, *args)`` returns ``(new_state, outputs)`` and the
  program keeps the state in buffers of its own: the graph ends with a
  copy of the new state into them, so nothing is rebound between calls.
  ``load_state`` and ``read_state`` copy in and out; the call returns
  ``outputs`` alone.
* The kernels' launch counters (``LAUNCH_COUNTERS``) are Python integers
  that the wrappers bump when they launch, and a replay runs no Python: a
  capture records the counters' change and undoes it (capturing launches
  nothing), and every replay adds that change again. A counter registered
  with ``register_counter(counter, keys)`` has only those keys added on a
  replay: ``parallel/mesh.py:COLLECTIVES`` counts its collectives' calls
  that way, while its host seconds count eager calls only.
* ``GRAPH_STATS`` counts the programs' own work, always: ``captures``, the
  first calls that captured; ``capture_s``, their host seconds (the warm-up
  run and the capture); ``replays``. It is no launch counter: a capture
  leaves it as it is. A capture while a server runs means that a program
  was built anew.
* A call that stages host arguments does so inside the span
  ``graph/stage`` (``utils/profiler.py``).

``cuda_graph`` chooses: ``None`` captures on a CUDA device and calls ``fn``
eagerly on the CPU (as the kernels' plain versions run only where the caller
asked for the CPU), ``True`` captures and raises ``ValueError`` for a CPU
device, ``False`` is the eager path. An eager program calls ``fn``, copies
the state it returns into the same buffers, and returns ``fn``'s own
outputs.
"""

import contextlib
import gc
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .profiler import profile_scope

# The launch counters of the kernels' wrappers: dicts (or Counters) of ints,
# registered by the kernel modules when they are imported.
LAUNCH_COUNTERS = []
# id(counter) -> the keys a replay adds to, for a counter registered with
# register_counter(counter, keys); the others are undone after a capture
_REPLAYED_KEYS = {}
# the programs' captures, their host seconds and their replays, over every
# program of the process; kept out of LAUNCH_COUNTERS, so that a capture
# neither undoes nor replays them
GRAPH_STATS = {"captures": 0, "replays": 0, "capture_s": 0.0}
_NO_SPAN = contextlib.nullcontext()      # a call that stages nothing


def register_counter(counter, keys=None):
    """Count `counter` (a dict of numbers) on every replay: all its keys, or
    only `keys`."""
    LAUNCH_COUNTERS.append(counter)
    if keys is not None:
        _REPLAYED_KEYS[id(counter)] = tuple(keys)


def use_graph(cuda_graph, device) -> bool:
    """Whether a program on `device` is captured: see the module docstring
    for the three values of cuda_graph."""
    device = torch.device(device)
    if cuda_graph is None:
        return device.type == "cuda"
    if cuda_graph and device.type != "cuda":
        raise ValueError(f"cuda_graph=True needs a CUDA device, got {device}")
    return bool(cuda_graph)


def as_argument(x, dtype):
    """x as a program's argument: a tensor as it is, anything else as a numpy
    array of `dtype` (a captured program stages it through pinned memory,
    an eager one is given it as it is)."""
    return x if torch.is_tensor(x) else np.asarray(x, dtype)


def _read_counters():
    return [dict(c) for c in LAUNCH_COUNTERS]


def _undo_counters(before):
    """Set every launch counter back to `before`; returns what each gained."""
    gained = []
    for c, was in zip(LAUNCH_COUNTERS, before):
        keys = _REPLAYED_KEYS.get(id(c), c)
        gained.append({k: v - was.get(k, 0) for k, v in c.items()
                       if v != was.get(k, 0) and k in keys})
        c.clear()
        c.update(was)
    return gained


def _add_counters(gained):
    for c, add in zip(LAUNCH_COUNTERS, gained):
        for k, v in add.items():
            c[k] = c.get(k, 0) + v


def _is_array(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, np.ndarray)


def _torch_dtype(x):
    return x.dtype if torch.is_tensor(x) else \
        torch.from_numpy(np.empty(0, x.dtype)).dtype


def _signature(x):
    if _is_array(x):
        return ("array", tuple(x.shape), _torch_dtype(x))
    return ("value", x)


class _Staging:
    """A pinned host buffer that numpy arguments (and CPU tensors) pass
    through on their way to a static input, and the event that marks the
    end of its last copy: the host waits for it before writing again."""

    def __init__(self, like: torch.Tensor):
        self.host = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        self.event = torch.cuda.Event()

    def copy(self, dst: torch.Tensor, x):
        self.event.synchronize()      # returns at once before any record
        if torch.is_tensor(x):
            self.host.copy_(x)
        else:
            np.copyto(self.host.numpy(), x, casting="no")
        dst.copy_(self.host, non_blocking=True)
        self.event.record()


class _Graph:
    """One key's captured graph, its static inputs (with their staging
    buffers), its static outputs and the launch counts of a replay."""

    def __init__(self, inputs, staging):
        self.graph = torch.cuda.CUDAGraph()
        self.inputs, self.staging = inputs, staging
        self.staged = any(st is not None for st in staging)
        self.outputs = None
        self.launches = None


class CapturedProgram:
    """A pure function of tensors run as one captured CUDA graph for each
    input signature on a CUDA device, or eagerly; see the module docstring
    for the contract.

    program(*args) -> outputs; with state=, fn(state, *args) -> (new_state,
    outputs). ``captured`` says which of the two it is; ``graphs`` is the
    number of keys captured so far."""

    def __init__(self, fn, device, *, state=None, cuda_graph=None):
        self.fn = fn
        self.device = torch.device(device)
        self.captured = use_graph(cuda_graph, self.device)
        self._graphs = {}
        self._pool = None
        self._side = None
        self._state = None if state is None else pytree.tree_map(
            lambda x: x.to(self.device).clone(), state)

    @property
    def graphs(self) -> int:
        return len(self._graphs)

    # ---- the state held by the program ----

    def load_state(self, state):
        """Copy `state` (tensors of the state's shapes and dtypes, on any
        device) into the program's state."""
        new, spec = pytree.tree_flatten(state)
        old, old_spec = pytree.tree_flatten(self._state)
        if spec != old_spec or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(new, old)):
            raise ValueError(
                "the state does not fit this program's: "
                f"{[(tuple(a.shape), a.dtype) for a in old]} vs "
                f"{[(tuple(a.shape), a.dtype) for a in new]}")
        for dst, src in zip(old, new):
            dst.copy_(src)

    def read_state(self):
        """A copy of the program's state, on its device."""
        return pytree.tree_map(torch.clone, self._state)

    def release(self):
        """Free every captured graph, its static buffers and the memory
        pool they share (it goes back to PyTorch's caching allocator). The
        state stays; the next call of a key captures it again."""
        for g in self._graphs.values():
            g.graph.reset()
        self._graphs.clear()
        self._pool = None

    # ---- calls ----

    def __call__(self, *args):
        if not self.captured:
            return self._run(args)
        flat, spec = pytree.tree_flatten(args)
        key = (spec, tuple(_signature(x) for x in flat))
        g = self._graphs.get(key)
        if g is None:
            t0 = time.perf_counter()
            out = self._first_call(key, flat, spec)
            GRAPH_STATS["capture_s"] += time.perf_counter() - t0
            GRAPH_STATS["captures"] += 1
            return out
        self._load(g, flat)
        g.graph.replay()
        _add_counters(g.launches)
        GRAPH_STATS["replays"] += 1
        return g.outputs

    def _run(self, args):
        if self._state is None:
            return self.fn(*args)
        new_state, out = self.fn(self._state, *args)
        for dst, src in zip(pytree.tree_leaves(self._state),
                            pytree.tree_leaves(new_state)):
            if src is not dst:
                dst.copy_(src)
        return out

    def _load(self, g: _Graph, flat):
        with profile_scope("graph/stage") if g.staged else _NO_SPAN:
            for dst, stage, x in zip(g.inputs, g.staging, flat):
                if stage is not None:
                    stage.copy(dst, x)
                elif torch.is_tensor(dst) and dst is not x:
                    dst.copy_(x)

    def _first_call(self, key, flat, spec):
        inputs, staging = [], []
        for x in flat:
            if not _is_array(x):
                inputs.append(x)
                staging.append(None)
                continue
            dst = torch.empty(tuple(x.shape), dtype=_torch_dtype(x),
                              device=self.device)
            inputs.append(dst)
            host = not torch.is_tensor(x) or x.device.type == "cpu"
            staging.append(_Staging(dst) if host else None)
        g = _Graph(inputs, staging)
        self._load(g, flat)
        args = pytree.tree_unflatten(inputs, spec)
        # the warm-up is this call's run, on a side stream that waits for
        # the copies above; the current stream waits for it in turn
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = self._run(args)
        cur.wait_stream(self._side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = _read_counters()
        # no garbage collection inside the capture: a program dropped in a
        # reference cycle (an object holding a program of its own bound
        # method) would free its graph and memory pool there, which
        # invalidates the capture; torch.cuda.graph collects on entry
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g.graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                g.outputs = self._run(args)
        finally:
            if collect:
                gc.enable()
            g.launches = _undo_counters(before)
        self._graphs[key] = g
        return out
