"""One SQP iteration as a CUDA graph, for the one-arm fused route and the
fleet.

On the fused route with the K3 merits and the tensors on a card
(``sqp.graph_engages``), ``sqp.sqp_solve`` runs here: each SQP iteration is
one ``graph.replay()`` of ``sqp._iteration`` captured once, in place of the
~45 launches the host would enqueue for it (K1, K2 or K2' -> K6, K3 and the
step's tensor ops).  By the same rule the fleet's
``parallel/batched_cuda.py::sqp_solve_batched_fused`` replays
``_batched_iteration`` (K8a -> K8b -> K8c -> K3b and the step's ~65 tensor
ops).  The SQP's mathematics lives in those two bodies alone; this module
only gives a body (``IterationGraph``: the body, its route and a state of
the key's shapes) memory of its own and replays it.

Memory.  A capture bakes in every pointer its launches take, so everything
the iteration reads or writes lives in memory that the captured graph owns:

  * the state (``sqp._State``, as ``sqp._initial_state`` forms it, for one
    arm or with the fleet's instance axis), the iteration's index and the
    route's tensors (the problem's xs and ee_goal, the PCG exit tolerance)
    are fields of one byte buffer of the entry (``_Flat``), each a view of
    its own dtype and shape;
  * what the iteration allocates (K1's outputs, K2's flags, the merits and
    their span scratch, the step's temporaries) comes from the graph's own
    memory pool; K3's span scratch is taken fresh inside the capture
    (``merit_cuda.fresh_span_scratch``), never the per-device cache that a
    larger eager launch would reallocate under the graph.

The iteration's index is a device int64 that the graph increments, so one
graph writes the per-iteration entries of every iteration it replays
(``sqp._put``, ``sqp._at``).  The graph counts the SQP iterations as well
where its body leaves the count to the loop (the arm's); the fleet's body
counts them per instance itself.

A solve copies its inputs into the buffer (xu, lam, xs, ee_goal, rho,
drho0: one ``_foreach_copy_``), resets the rest in one copy, runs
``sqp._loop`` with one replay per SQP iteration (so it reads the stop flag
between iterations as the eager loop does), and returns fresh copies of the
buffer's result fields (the plan, and the rest), the result's fields views
of them: no later solve overwrites a result.

Graphs are cached under everything their capture bakes in (``_key`` for
the arm, ``batched_cuda._graph_key`` for the fleet); the cache holds at
most ``MAX_GRAPHS``, the least recently used dropped first.  A key's first
SQP iteration runs eagerly on the buffer (every module loaded, every plan
cached, ``model.packed()`` built outside the graph's pool); the capture
follows it, on a stream of its own.  The kernel wrappers' launch counts
(``.launches``) count each replay's launches, as eager calls would.

Under a ``torch.profiler`` session a solve records its ``sqp.solve`` and
``sqp.stop_read`` spans, one ``sqp.replay`` span per replay, the host
counters ``sqp.replays`` and ``sqp.captures``, and per iteration the
entry's own host counts (the fleet's K8a knot stages and knots)
(``utils/profiling.py``); each iteration's lam is kept as a copy, never
the buffer itself.
"""

from __future__ import annotations

import collections
import math

import torch

from mpcgpu_tpu_torch import _kernels
from mpcgpu_tpu_torch.solver import merit_cuda, sqp
from mpcgpu_tpu_torch.utils import profiling

# the most graphs kept at once (one per key), least recently used dropped
MAX_GRAPHS = 8
# byte alignment of every field of the buffer
FIELD_ALIGN = 64
# the buffer's state fields in its order: the result's (SQPResult's, the
# solve's inputs xu, lam, rho, drho first), then the rest of the state
_RES = sqp.SQPResult._fields
FIELDS = _RES + tuple(f for f in sqp._State._fields if f not in _RES)
# spans of the buffer's fields (first, last): reset each solve in one copy,
# every field after the solve's inputs up to the iteration's index; and the
# result's two copies, the plan and the rest, so that a caller who keeps a
# result's small fields keeps no plan alive (and, at most 8 fields, holds
# one 512-byte block of the allocator)
RESET = (FIELDS[4], "it")
RESULT = ((_RES[0], _RES[1]), (_RES[2], _RES[-1]))
# the wrappers the arm's iteration can call on the fused route, whose
# .launches a replay advances (the fleet's: batched_cuda.WRAPPERS)
WRAPPERS = (sqp.build_kkt_schur, sqp.pcg_dz_solve, sqp.pcg_solve_cuda,
            sqp.compute_dz_cuda, sqp.line_search_merits_fused)

_GRAPHS: collections.OrderedDict = collections.OrderedDict()


def _padded(nbytes: int) -> int:
    """A field's bytes in the buffer: whole ``FIELD_ALIGN`` units, at least
    one (an empty field too, so that no two fields share an offset)."""
    return max(1, -(-nbytes // FIELD_ALIGN)) * FIELD_ALIGN


class _Flat:
    """Fields carved from one byte buffer in the order given, each
    ``FIELD_ALIGN``-aligned: ``views(buf)`` gives every field as a view of
    ``buf`` of its dtype and shape."""

    def __init__(self, fields, device):
        self.slots, off = {}, 0
        for name, shape, dtype in fields:
            nbytes = math.prod(shape) * dtype.itemsize
            self.slots[name] = (off, nbytes, tuple(shape), dtype)
            off += _padded(nbytes)
        self.buf = torch.zeros((off,), dtype=torch.uint8, device=device)

    def views(self, buf) -> dict:
        return {name: buf[o:o + n].view(dtype).view(shape)
                for name, (o, n, shape, dtype) in self.slots.items()}

    def span(self, first: str, last: str) -> slice:
        """The bytes from field ``first`` to the end of field ``last``, its
        padding included."""
        o, _, _, _ = self.slots[first]
        e, n, _, _ = self.slots[last]
        return slice(o, e + _padded(n))

    def layout(self, span: slice) -> list:
        """Each field in ``span``: (name, dtype, shape, contiguous strides,
        offset in elements of its dtype from the span's start)."""
        out = []
        for name, (o, n, shape, dtype) in self.slots.items():
            if span.start <= o < span.stop:
                strides = [1] * len(shape)
                for i in range(len(shape) - 2, -1, -1):
                    strides[i] = strides[i + 1] * shape[i + 1]
                out.append((name, dtype, shape, tuple(strides),
                            (o - span.start) // dtype.itemsize))
        return out


def _key(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal, dt, max_iter,
         integrator_type, angle_wrap, fused_dz) -> tuple:
    """Everything a capture bakes in: the card, the inputs' shapes and
    dtypes (N, nq), the model by identity, dt, the route's flags, the cost,
    SQP and PCG settings, and the per-iteration buffers' length."""
    return (xu.device, tuple((tuple(t.shape), t.dtype) for t in (xu, lam, xs, ee_goal)),
            id(model), float(dt), int(integrator_type), bool(angle_wrap),
            bool(fused_dz), cost, sqp_cfg, pcg_cfg, int(max_iter))


class IterationGraph:
    """One key's buffer, its iteration body and route (the route's tensors
    replaced by the buffer's fields) and, once captured, its graph.

    ``body(route, state, it) -> state`` is one SQP iteration
    (``sqp._iteration``, ``batched_cuda._batched_iteration``); ``init`` a
    state of the key's shapes (``sqp._initial_state``), whose reset fields
    every solve starts from; ``wrappers`` the kernel wrappers the body
    calls, whose launch counts a replay advances; ``host_counts`` the
    (host counter, n) pairs a traced iteration counts."""

    def __init__(self, body, route, init: sqp._State, wrappers=WRAPPERS,
                 host_counts=()):
        dev = init.xu.device
        self.body, self.wrappers, self.host_counts = body, wrappers, host_counts
        # held so that the model (the key holds its id) and its packed
        # arrays, whose pointers the capture bakes in, outlive the graph
        self.model, self.packed = route.model, None
        tensors = {f: x for f, x in zip(route._fields, route)
                   if isinstance(x, torch.Tensor)}
        fields = {**{f: getattr(init, f) for f in FIELDS},
                  "it": torch.zeros((1,), dtype=torch.int64, device=dev), **tensors}
        self.flat = _Flat([(f, t.shape, t.dtype) for f, t in fields.items()], dev)
        v = self.v = self.flat.views(self.flat.buf)
        torch._foreach_copy_([v[f] for f in fields], list(fields.values()))
        self.reset = self.flat.buf[self.flat.span(*RESET)]
        self.init = self.reset.clone()
        # per copy of the result: its bytes in the buffer and its fields
        self.results = [(self.flat.buf[span], self.flat.layout(span))
                        for span in (self.flat.span(*r) for r in RESULT)]
        self.route = route._replace(**{f: v[f] for f in tensors})
        self.state = sqp._State(**{f: v[f] for f in sqp._State._fields})
        self.graph, self.launches = None, ()
        self.capturable = dev.type == "cuda"

    def load(self, xu, lam, xs, ee_goal, rho, drho0) -> None:
        """A solve's inputs into the buffer (the tensors in one
        ``_foreach_copy_``, a float rho or drho0 by a fill), the rest
        reset in one copy."""
        v = self.v
        self.reset.copy_(self.init)
        dst, src = [v["xu"], v["lam"], v["xs"], v["ee_goal"]], [xu, lam, xs, ee_goal]
        for name, x in (("rho", rho), ("drho", drho0)):
            if isinstance(x, torch.Tensor):
                shape = v[name].shape
                dst.append(v[name])
                src.append(x if x.shape == shape else x.reshape(shape))
            else:
                v[name].fill_(float(x))
        torch._foreach_copy_(dst, src)

    def step(self) -> None:
        """One SQP iteration on the buffer, eagerly or into a capture: the
        state fields the iteration returns anew copied back, the index
        advanced, and the iteration counted where the body leaves the
        count to the loop."""
        new = self.body(self.route, self.state, self.v["it"])
        for old, now in zip(self.state, new):
            if now is not old:
                old.copy_(now)
        self.v["it"].add_(1)
        if new.sqp_iters is self.state.sqp_iters:
            self.v["sqp_iters"].add_(1)

    def iterate(self, st, it: int, tr) -> sqp._State:
        """``sqp._loop``'s iteration: a replay, or (a key's first) ``step``
        run eagerly and then captured; the state is the buffer's."""
        if self.graph is not None:
            if tr:
                tr.phase("sqp.replay", it)
            self.replay()
            if tr:
                tr.phase(None)
                tr.count("sqp.replays")
        else:
            if tr:
                tr.phase(None, it)
            self.step()
            if self.capturable:
                self.capture()
                if tr:
                    tr.count("sqp.captures")
        if tr:
            tr.lam_solved(self.v["lam"], copy=True)
            for name, n in self.host_counts:
                tr.count(name, n)
        return st

    def capture(self) -> None:
        """Capture ``step`` into the entry's graph, on a stream of its own;
        the wrappers' launch counts are left as they were, and each replay
        advances them by what the capture launched."""
        dev = self.v["xu"].device
        self.packed = self.model.packed()
        before = [w.launches for w in self.wrappers]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), merit_cuda.fresh_span_scratch(dev):
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev),
                                  capture_error_mode="thread_local"):
                self.step()
        self.launches = tuple((w, w.launches - n)
                              for w, n in zip(self.wrappers, before)
                              if w.launches != n)
        for w, n in zip(self.wrappers, before):
            w.launches = n
        self.graph = graph

    def replay(self) -> None:
        dev = self.v["xu"].device
        if torch.cuda.current_device() == dev.index:
            self.graph.replay()
        else:
            with torch.cuda.device(dev):
                self.graph.replay()
        for w, n in self.launches:
            w.launches += n

    def result(self) -> sqp.SQPResult:
        """The result as fresh copies of the buffer's two result spans (two
        launches), its fields views of them: one dtype view of a copy per
        dtype and one ``as_strided`` per field, the fewest host operations
        (a slice and two views a field cost the H100's host ~100 µs a
        solve)."""
        out = {}
        for src, fields in self.results:
            copy, typed = src.clone(), {}
            for name, dtype, shape, strides, offset in fields:
                if dtype not in typed:
                    typed[dtype] = copy.view(dtype)
                out[name] = typed[dtype].as_strided(shape, strides, offset)
        return sqp.SQPResult(**out)

    def solve(self, tr, iter_bound: int, xu, lam, xs, ee_goal, rho,
              drho0) -> sqp.SQPResult:
        """One solve on the entry (module docstring): the inputs loaded,
        ``sqp._loop`` with one replay per SQP iteration (or, the key's
        first, run eagerly and then captured), the result's fresh copies;
        ``tr`` the solve's recorder (``profiling.solve_trace``)."""
        self.load(xu, lam, xs, ee_goal, rho, drho0)
        sqp._loop(self.iterate, self.state, iter_bound, tr)
        result = self.result()
        if tr:
            tr.finish(result)
        return result


def cached(key, model, make) -> IterationGraph:
    """The cached entry of ``key``, made anew by ``make()`` where there is
    none or where the model's packed arrays are no longer the ones its
    graph baked in; at most ``MAX_GRAPHS`` kept, the least recently used
    dropped first."""
    g = _GRAPHS.get(key)
    if g is not None and g.model is model and (
            g.packed is None or g.packed is model.packed()):
        _GRAPHS.move_to_end(key)
        return g
    g = _GRAPHS[key] = make()
    _GRAPHS.move_to_end(key)
    while len(_GRAPHS) > MAX_GRAPHS:
        _GRAPHS.popitem(last=False)
    return g


def iteration_graph(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal, dt,
                    max_iter, integrator_type, angle_wrap,
                    fused_dz) -> IterationGraph:
    """The arm's cached entry of the call's key (``_key``, ``cached``):
    ``sqp._iteration`` on the fused route with the K3 merits."""

    def make():
        dev, dtype = xu.device, xu.dtype
        exit_tol = _kernels.scalar(pcg_cfg.exit_tol, dev, dtype)
        zero = torch.zeros((), dtype=dtype, device=dev)
        init = sqp._initial_state(xu, lam, zero, zero, exit_tol, max_iter, pcg_cfg)
        route = sqp._Route(model, cost, sqp_cfg, pcg_cfg, xs, ee_goal, dt,
                           "pcg_cuda", integrator_type, angle_wrap, True, True,
                           fused_dz, exit_tol, None, None)
        return IterationGraph(sqp._iteration, route, init)

    return cached(_key(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal, dt,
                       max_iter, integrator_type, angle_wrap, fused_dz),
                  model, make)


def clear() -> None:
    """Drop every cached graph."""
    _GRAPHS.clear()


def solve(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal, rho, dt,
          max_iter: int, iter_bound: int, integrator_type: int, drho0,
          angle_wrap: bool, fused_dz: bool) -> sqp.SQPResult:
    """``sqp.sqp_solve`` on the graph path (module docstring): the eager
    loop's iterations, stop-flag reads and result, each iteration a replay
    (or, a key's first, run eagerly and then captured)."""
    tr = profiling.solve_trace(1)
    g = iteration_graph(model, cost, sqp_cfg, pcg_cfg, xu, lam, xs, ee_goal,
                        dt, max_iter, integrator_type, angle_wrap, fused_dz)
    return g.solve(tr, iter_bound, xu, lam, xs, ee_goal, rho, drho0)
