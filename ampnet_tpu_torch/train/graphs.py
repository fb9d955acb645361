"""CUDA-graph capture of the port's steps: its counterpart of ``jax.jit``
(one dispatch per step) and of ``lax.scan`` over steps (one dispatch per k
steps). The JAX package has no such module: XLA compiles each step into one
executable, where PyTorch would launch every kernel of a step from the host.

``Captured`` runs a step body once on a side stream (the warm-up that
capture needs: cuBLAS handles, autograd's streams; one step of a k-step
body is enough), puts back everything that run wrote (parameters, the optimizer's tensors, the generator, the
launch counters), then captures the body, backward and optimizer step
included, into one ``torch.cuda.CUDAGraph`` over static copies of its
inputs. ``replay`` copies a call's inputs into those copies, launches the
graph with one host call and adds the launches the capture recorded to the
kernels' counters, so that a replayed step counts as an eager one does.

Random draws: the body draws from a generator of the graph's own,
registered with the graph; the caller's generator state is set on it
before each replay and taken back after, so that a replay draws what the
eager body would draw from the same state, and the caller's generator
advances as it would.

A capture that fails raises ``CaptureError`` naming the source line and
the op that broke it; nothing falls back to the eager body.
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback
from collections import OrderedDict
from typing import Any, Callable, Iterable, Optional

import torch

from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as bwd_stream
from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

# graphs a step keeps (each holds its private memory pool); the oldest goes
# first, as a new shape (a GraphSAINT budget regrow) captures anew
MAX_GRAPHS = 4


class CaptureError(RuntimeError):
    """A step body could not be captured into a CUDA graph."""


def signature(obj) -> Any:
    """What a captured graph is specialized to: every tensor's shape, type
    and device, and every other field's value, through dataclasses and
    tuples."""
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape), obj.dtype, obj.device)
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, *((f.name, signature(getattr(obj, f.name)))
                                      for f in dataclasses.fields(obj)))
    if isinstance(obj, (tuple, list)):
        return tuple(signature(o) for o in obj)
    return obj


def dispatch_flags() -> tuple:
    """The fused op's module constants that its dispatch reads at call time
    (the forward route, the backward, the stream's chunk budget, the bf16
    operands and streams): a graph captured under one setting replays that
    setting's kernels. The model's compute type is in the key already, as
    part of its config."""
    return (eaf.MM_SCATTER_DEFAULT, eaf.DMA_V1_DEFAULT, eaf.SCATTERFREE_BWD_DEFAULT,
            bwd_stream._STREAM_CHUNK_BYTES, eaf.MXU_BF16_DEFAULT, eaf.STREAM_BF16_DEFAULT)


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _clone(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(_clone(o) for o in obj)
    return obj


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _copy_into(getattr(dst, f.name), getattr(src, f.name))
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


_STREAMS: dict = {}


def _side_stream() -> torch.cuda.Stream:
    """The one stream per device that every warm-up and capture runs on:
    what a warm-up allocates stays cached there for the next one (the
    allocator keeps blocks per stream), and cuBLAS makes its workspace for
    it once."""
    dev = torch.cuda.current_device()
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream()
    return _STREAMS[dev]


def _failure(err: BaseException, what: str) -> str:
    """Where a capture broke: the innermost line outside torch of the first
    error (a failed capture raises again when it ends), and that error."""
    root = err
    while root.__context__ is not None:
        root = root.__context__
    torch_dir = os.path.dirname(torch.__file__)
    frames = traceback.extract_tb(root.__traceback__)
    ours = [f for f in frames if not f.filename.startswith(torch_dir)] or frames
    where = (f"{ours[-1].filename}:{ours[-1].lineno} in {ours[-1].name}: "
             f"`{ours[-1].line}`") if ours else "an unknown line"
    return (f"CUDA graph capture of {what} failed at {where}: "
            f"{type(root).__name__}: {str(root).strip().splitlines()[0]}")


class Captured:
    """``body(*static_inputs)`` captured into one CUDA graph.

    ``inputs`` is a tuple of tensors, dataclasses of tensors (Graph,
    EdgeLayout) or None; the graph runs on static copies of them.
    ``writes``: every tensor the body updates in place (parameters, the
    optimizer's tensors), put back after the warm-up. ``generator``: the
    graph's own generator, which the body draws from. ``warmup`` (default:
    the body) is what the warm-up runs: one of the body's k steps or draws
    touches everything the capture needs made first. ``timing`` holds the
    host ms of the warm-up, of recording the body and of ending the capture
    (which instantiates the graph)."""

    def __init__(self, body: Callable, inputs: tuple, *, writes: Iterable[torch.Tensor] = (),
                 generator: Optional[torch.Generator] = None, what: str = "a step",
                 warmup: Optional[Callable] = None):
        self.generator = generator
        self.static = _clone(inputs)
        writes = list(writes)
        t0 = time.perf_counter()
        # without history: a clone with it keeps each parameter's gradient
        # node, made on this stream, alive into the side stream's warm-up
        with torch.no_grad():
            saved = [t.clone() for t in writes]
        gen_state = None if generator is None else generator.get_state()
        before = eaf.counter_state()
        side = _side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            (warmup or body)(*self.static)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, v in zip(writes, saved):
                t.copy_(v)
        eaf.add_counts(eaf.counts_since(before), -1)
        del saved

        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            generator.set_state(gen_state)
            self.graph.register_generator_state(generator)
        before = eaf.counter_state()
        # capture_begin/capture_end, not torch.cuda.graph: that one empties
        # the allocator's cache (and may collect garbage) first, which costs
        # more than the capture and makes the next eager work allocate anew
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin()
                try:
                    self.outputs = body(*self.static)
                finally:
                    t2 = time.perf_counter()
                    self.graph.capture_end()
        except Exception as err:
            raise CaptureError(_failure(err, what)) from err
        finally:
            # what the capture counted is what each replay launches
            self.launches = eaf.counts_since(before)
            eaf.add_counts(self.launches, -1)
            if generator is not None:
                generator.set_state(gen_state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        self.timing = dict(warmup_ms=(t1 - t0) * 1e3, record_ms=(t2 - t1) * 1e3,
                           end_ms=(t3 - t2) * 1e3)

    def replay(self, inputs: tuple):
        """Run the graph on ``inputs`` (same signature as the captured
        ones); returns the static outputs, overwritten by the next replay."""
        _copy_into(self.static, inputs)
        self.graph.replay()
        eaf.add_counts(self.launches)
        return self.outputs


class GraphCache:
    """The graphs of one step function by key, the oldest dropped past
    MAX_GRAPHS."""

    def __init__(self):
        self._graphs: "OrderedDict[Any, Captured]" = OrderedDict()

    def timings(self) -> list:
        """Each held graph's ``Captured.timing``, oldest first."""
        return [g.timing for g in self._graphs.values()]

    def get(self, key, make: Callable[[], Captured]) -> Captured:
        if key in self._graphs:
            self._graphs.move_to_end(key)
        else:
            self._graphs[key] = make()
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        return self._graphs[key]
