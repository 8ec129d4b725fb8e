"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX engine runs IHT_STEPS_PER_DISPATCH batches in one device program
(a ``fori_loop`` under ``jit``), so the host pays one dispatch per k
batches. The port's batch is some 60 (BENCH_CFG) to 5000 (MS_CFG) kernel
launches through PyTorch's dispatcher; launched one by one from Python they
cost more host time than the card needs to run them. A CUDA graph records
the launches of one batch once and replays them with one call.

A batch is capturable because nothing in it is a host value that changes
between batches: the batch counter, the ray base and the pool sampler's
shape index live on the device and are advanced there; the accumulators
and the running sums are updated in place at fixed addresses; the choice
between the compacted and the full fold is not made inside the batch (the
captured batch always compacts and records an overflow on the device; the
engine reads that once per dispatch and replays the dispatch up to the
overflowing batch, which it then runs eagerly).

The gradient path (engine/gradient.py, grad_validation.py) is compiled the
same way: ``GradGraph`` captures a forward and its backward as two graphs
replayed inside a ``torch.autograd.Function``, so that the compiled render
stays differentiable as a jitted JAX function is under ``jax.grad``. Its
calls copy new values into the static inputs and return clones of the
static outputs: a later call never overwrites what an earlier one
returned.

No fallback: a capture or a replay that fails raises.

Stale captures: ``invalidate()`` marks every graph captured so far stale,
and its owner (``Engine``, ``RenderProgram``) captures again before its
next replay. utils/profiling.py calls it as a profiler window opens: a
window over replays of graphs captured earlier in the process crashed
inside ``cudaGraphLaunch`` now and then, and never over graphs captured
just before it.

Launch counts (``kernels.build.LAUNCHES``): a capture records launches, it
does not run them, so the counts its wrappers added are taken back and
added again on every replay, which launches each recorded kernel once.
"""

from __future__ import annotations

import time

import torch

from ice_halo_sim_tpu_torch.kernels import build

# Eager runs of a step before its capture (first-use allocations, module
# loads and lazy initialisation happen there, not in the graph).
WARMUP = 2

# The generation of captures: ``invalidate()`` starts a new one.
_generation = 0


def invalidate() -> None:
    """Mark every graph captured so far stale (see the module docstring)."""
    global _generation
    _generation += 1


class _Capture:
    """The generation a graph was captured in."""

    def __init__(self):
        self._captured_in = _generation

    @property
    def stale(self) -> bool:
        """Whether ``invalidate()`` was called since the capture: the owner
        captures again instead of replaying."""
        return self._captured_in != _generation


def _warm_up(fn, device, n: int) -> None:
    """n calls of fn on a side stream of `device`, then the current stream
    waits for them."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(n):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)


def _capture(graph, fn, stream, pool=None):
    """fn captured into `graph` on `stream` (``thread_local``: a capture may
    run on a server's pump thread while another thread uses the card; in
    the default "global" mode a CUDA call from any thread during the capture
    would abort it). Returns (fn's result, the launches the capture
    counted), the counts taken back."""
    before = dict(build.LAUNCHES)
    with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
        out = fn()
    launches = {k: v - before[k] for k, v in build.LAUNCHES.items() if v != before[k]}
    for k, v in launches.items():
        build.LAUNCHES[k] -= v
    return out, launches


def _replay(graph, device, launches) -> None:
    with torch.cuda.device(device):
        graph.replay()
    for k, v in launches.items():
        build.LAUNCHES[k] += v


class BatchGraph(_Capture):
    """`step` (one batch, all its effects on tensors that outlive it)
    captured on `device`. Construction runs one real batch first, eagerly on
    a side stream (the warm-up that PyTorch asks of a capture: first-use
    allocations and module loads happen there), then captures one call,
    which runs nothing. ``replay`` runs one more batch. `key` records what
    the capture assumed (plan, addresses); the owner compares it to decide
    when to capture again."""

    def __init__(self, step, key, device):
        super().__init__()
        self.key = key
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        # Everything under `device`: its side stream, its capture stream (not
        # torch's default capture stream, made once on whichever device was
        # current first) and the current device the kernels launch on.
        with torch.cuda.device(device):
            _warm_up(step, device, 1)
            _, self.launches = _capture(self.graph, step, torch.cuda.Stream(device))

    def replay(self) -> None:
        _replay(self.graph, self.device, self.launches)


def _reserved_after_empty_cache(device) -> int:
    """The device memory the caching allocator reserves once its unused
    cached blocks are released (a capture releases them too, so the
    reservation it adds is its graph's private pool)."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


def _flat(out) -> list:
    """A tensor or a (nested) tuple of tensors as a flat list."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def _static(example, device) -> torch.Tensor:
    """A static input of the example's dtype and shape on `device`, holding
    the example's value."""
    return torch.as_tensor(example).detach().to(device).clone()


def _write(static, value) -> None:
    """A call's value into a static input: a number by fill_, a tensor by
    copy_ (its shape must be the input's: copy_ would broadcast)."""
    if isinstance(value, torch.Tensor):
        if value.shape != static.shape:
            raise ValueError(f"an input of shape {tuple(value.shape)} for a static input of "
                             f"shape {tuple(static.shape)}")
        static.copy_(value)
    else:
        static.fill_(value)


def _zeros_for_unused(grads, wrt) -> list:
    """torch.autograd.grad's result with zeros where an input was unused
    (None): a captured step returns a tensor for every input."""
    return [torch.zeros_like(w) if g is None else g for g, w in zip(grads, wrt)]


class GradGraph(_Capture):
    """`fn(*inputs) -> tensor or tuple of tensors`, its forward and its
    backward each captured on a CUDA device as a CUDA graph (one memory
    pool), differentiable in the inputs at `diff`. ``apply(graph, *args)``
    runs it inside a ``torch.autograd.Function``: the forward replays the
    forward graph and returns clones of its outputs; the backward writes the
    incoming gradients into static buffers and replays the backward graph
    (``torch.cuda.make_graphed_callables``'s design, with the port's device
    guard, capture stream, launch counts and fresh outputs). The floating
    outputs that depend on a `diff` input are differentiable, the others
    (indices, masks) are not. A gradient to a `diff` input the outputs do
    not depend on is zeros.

    The saved tensors of a call live in the graph's pool, so a backward must
    run before the next forward of the same graph; one that comes after it
    raises. ``capture_ms`` is the warm-up and the capture's wall time,
    ``held_bytes`` the device memory the capture reserved (the graphs'
    private pool), which it keeps between calls."""

    def __init__(self, fn, args, device, diff):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError("GradGraph captures on a CUDA device")
        self.inputs = [_static(a, self.device) for a in args]
        self.diff = tuple(diff)
        wrt = [self.inputs[i] for i in self.diff]
        for w in wrt:
            w.requires_grad_(True)

        def forward():
            with torch.enable_grad():
                return _flat(fn(*self.inputs))

        def step():
            outs = [o for o in forward() if o.requires_grad]
            torch.autograd.grad(outs, wrt, grad_outputs=[torch.ones_like(o) for o in outs],
                                allow_unused=True)

        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            _warm_up(step, self.device, WARMUP)
            held = _reserved_after_empty_cache(self.device)
            stream = torch.cuda.Stream(self.device)
            self.fwd = torch.cuda.CUDAGraph()
            self.outputs, self.fwd_launches = _capture(self.fwd, forward, stream)
            self.diff_out = [i for i, o in enumerate(self.outputs) if o.requires_grad]
            self.grad_outputs = [torch.empty_like(self.outputs[i]) for i in self.diff_out]

            def backward():
                with torch.enable_grad():
                    grads = torch.autograd.grad(
                        [self.outputs[i] for i in self.diff_out], wrt,
                        grad_outputs=self.grad_outputs, retain_graph=True, allow_unused=True)
                return _zeros_for_unused(grads, wrt)

            self.bwd = torch.cuda.CUDAGraph()
            self.grads, self.bwd_launches = _capture(self.bwd, backward, stream,
                                                     pool=self.fwd.pool())
            torch.cuda.synchronize(self.device)
            self.held_bytes = torch.cuda.memory_reserved(self.device) - held
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.generation = 0

    def forward(self, args) -> list:
        for s, v in zip(self.inputs, args):
            _write(s, v)
        _replay(self.fwd, self.device, self.fwd_launches)
        self.generation += 1
        return [o.detach().clone() for o in self.outputs]

    def backward(self, generation: int, grad_outputs) -> list:
        if generation != self.generation:
            raise RuntimeError(
                "the backward of a replayed render ran after a later forward of the same "
                "program, which overwrote the tensors it saved; run each backward before "
                "the next call")
        for s, g in zip(self.grad_outputs, grad_outputs):
            s.copy_(g)
        _replay(self.bwd, self.device, self.bwd_launches)
        return [g.clone() for g in self.grads]

    @staticmethod
    def apply(graph: "GradGraph", *args):
        """The outputs of one call, as a tuple; differentiable (see the
        class)."""
        if len(args) != len(graph.inputs):
            raise TypeError(f"{len(args)} values for {len(graph.inputs)} static inputs")
        return _Replayed.apply(graph, *args)


class _Replayed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, graph, *args):
        outs = graph.forward(args)
        ctx.graph, ctx.generation = graph, graph.generation
        ctx.mark_non_differentiable(*(o for i, o in enumerate(outs)
                                      if i not in graph.diff_out))
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grad_outputs):
        graph = ctx.graph
        grads = graph.backward(ctx.generation, [grad_outputs[i] for i in graph.diff_out])
        out = [None] * (1 + len(graph.inputs))
        for i, g in zip(graph.diff, grads):
            out[1 + i] = g
        return tuple(out)
