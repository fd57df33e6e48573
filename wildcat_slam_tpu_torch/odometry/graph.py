"""The sweep as one device program: CUDA graphs captured once, replayed every sweep.

Counterpart of the JAX package's ``jax.jit(process_sweep, donate_argnames=
("state",))``: one device program a sweep, its state updated in place, its
LM loop (a ``lax.while_loop`` with a ``lax.cond`` re-linearisation) decided
on the device. :class:`SweepGraph` captures ``pipeline.process_sweep`` for
one window and one (config, emit_cloud) into CUDA graphs that read the
window state and the feed from static buffers and end by writing the new
state into the state's buffers (the donation). The torch of the card's
machine (2.11) captures graphs but has no conditional graph nodes, so the
capture splits at the LM loop: a graph before it, one LM step, one
re-linearisation, a graph after it. ``csrc/sweep_graph.cu`` puts them
together with the CUDA runtime's graph API into one executable graph whose
LM loop is a conditional WHILE node: the step writes its (re-linearise,
done) flags on the device, a one-thread kernel reads them and sets the
loop's and the re-linearisation's conditions (``solver.lm_loop_eager``'s
decision). A sweep is then one graph launch and no host sync.

:class:`FeedBuffer` moves a sweep's feed arrays in one pinned transfer,
:class:`HostCopy` brings an output back without waiting for it.

The kernels' wrappers count their launches when they are called, which
under capture is once per captured launch, and replays do not call them.
``CAPTURED`` counts the launches made while capturing (which ran nothing);
each captured graph ends with a small add of the launches it holds to a
counter on its device, so the launches a run made are ``LAUNCHES -
CAPTURED`` plus the device counters, for each wrapper (:func:`launches`;
reading the counters synchronises, so only the measurements do).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import gc
import time

import numpy as np
import torch

from wildcat_slam_tpu_torch.odometry.states import TensorStruct
from wildcat_slam_tpu_torch.ops import (_build, imu_factor, knn, pcg, self_match, spd,
                                        surfel_extract, surfel_factor)

KERNELS = ("pcg", "knn", "knn_mxu", "self_match", "spd", "imu_factor", "surfel_factor",
           "surfel_extract")
CAPTURED: collections.Counter = collections.Counter()
_REPLAYED = {}  # device -> (len(KERNELS),) int64 launch counter that the graphs add to


def wrapper_counts() -> collections.Counter:
    """The kernel wrappers' launch counts, by kernel."""
    return collections.Counter(pcg=pcg.LAUNCHES, knn=knn.LAUNCHES, knn_mxu=knn.MXU_LAUNCHES,
                               self_match=self_match.LAUNCHES, spd=spd.LAUNCHES,
                               imu_factor=imu_factor.LAUNCHES,
                               surfel_factor=surfel_factor.LAUNCHES,
                               surfel_extract=surfel_extract.LAUNCHES)


def replay_counter(dev: torch.device) -> torch.Tensor:
    """The device's counter of launches that graph replays ran (made on
    first use, outside any capture: the graphs hold its address)."""
    if dev not in _REPLAYED:
        _REPLAYED[dev] = torch.zeros(len(KERNELS), dtype=torch.int64, device=dev)
    return _REPLAYED[dev]


def reset_counts() -> None:
    """Every launch count to 0: the wrappers', the captures' and the replays'."""
    pcg.LAUNCHES = knn.LAUNCHES = knn.MXU_LAUNCHES = self_match.LAUNCHES = spd.LAUNCHES = 0
    imu_factor.LAUNCHES = surfel_factor.LAUNCHES = surfel_extract.LAUNCHES = 0
    CAPTURED.clear()
    for counter in _REPLAYED.values():
        counter.zero_()


def launches() -> dict:
    """Kernel launches since :func:`reset_counts`: those made eagerly plus
    those replays ran (a capture's own calls launched nothing)."""
    counts = wrapper_counts()
    replayed = collections.Counter()
    for counter in _REPLAYED.values():
        replayed.update(dict(zip(KERNELS, counter.tolist())))
    return {k: counts[k] - CAPTURED[k] + replayed[k] for k in KERNELS}


def device_guard(dev: torch.device):
    """``dev`` as the current CUDA device inside the block (nothing for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _leaves(state) -> list:
    """The tensors of a window state (nested dataclasses of tensors), in field order."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out.extend(_leaves(v) if isinstance(v, TensorStruct) else [v])
    return out


def _clone_state(state):
    """A copy of a window state in fresh storage, one tensor a field."""
    fields = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        fields[f.name] = _clone_state(v) if isinstance(v, TensorStruct) else v.clone()
    return type(state)(**fields)


def _write_back(static, new) -> None:
    """Write the new state into the static one's buffers. A new field that
    is a static buffer itself is left; one that shares a static buffer's
    storage is copied out first, so no write reads what another overwrote."""
    statics, news = _leaves(static), _leaves(new)
    storages = {t.untyped_storage().data_ptr() for t in statics}
    srcs = [None if n is s else (n.clone() if n.untyped_storage().data_ptr() in storages else n)
            for s, n in zip(statics, news, strict=True)]
    for s, n in zip(statics, srcs):
        if n is not None:
            s.copy_(n)


class FeedBuffer:
    """A sweep's feed arrays (``LidarOdometry._prepare_feed``) in one buffer:
    packed on the host into pinned memory (two buffers, used in turn, each
    rewritten only after its last copy finished) and moved to the device by
    one copy of ``slots`` feeds at most, where each array of each slot is a
    view (``views[slot]``)."""

    def __init__(self, template, device, slots: int = 1):
        self.device = torch.device(device)
        self.layout = []  # (byte offset, shape, numpy dtype) a feed array
        off = 0
        for a in template:
            a = np.asarray(a)
            off = -(-off // 16) * 16
            self.layout.append((off, a.shape, a.dtype))
            off += a.nbytes
        self.nbytes = -(-off // 16) * 16
        self.slots = slots
        pin = self.device.type == "cuda"
        self.host = [torch.empty(slots * self.nbytes, dtype=torch.uint8, pin_memory=pin)
                     for _ in range(2)]
        self._copied = [None, None]
        self._turn = 0
        self.buffer = torch.empty(slots * self.nbytes, dtype=torch.uint8, device=self.device)
        self.views = [self._views(s) for s in range(slots)]

    def _views(self, slot: int) -> tuple:
        base = slot * self.nbytes
        out = []
        for off, shape, dt in self.layout:
            n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            tdt = torch.from_numpy(np.zeros(0, dt)).dtype
            out.append(self.buffer[base + off:base + off + n].view(tdt).reshape(shape))
        return tuple(out)

    def put(self, feeds) -> None:
        """Copy ``feeds`` (at most ``slots`` tuples of numpy arrays) to slots
        0, 1, ... in one transfer on the current stream."""
        if not 1 <= len(feeds) <= self.slots:
            raise ValueError(f"FeedBuffer.put: {len(feeds)} feeds for {self.slots} slots")
        i, self._turn = self._turn, self._turn ^ 1
        if self._copied[i] is not None and not self._copied[i].query():
            self._copied[i].synchronize()  # the host lapped the card: wait for the old copy
        h = self.host[i].numpy()
        for s, feed in enumerate(feeds):
            for (off, shape, dt), a in zip(self.layout, feed, strict=True):
                a = np.asarray(a, dtype=dt)
                if a.shape != shape:
                    raise ValueError(f"FeedBuffer.put: feed array of shape {a.shape}, the "
                                     f"buffer holds {shape}")
                start = s * self.nbytes + off
                h[start:start + a.nbytes] = a.reshape(-1).view(np.uint8)
        n = len(feeds) * self.nbytes
        self.buffer[:n].copy_(self.host[i][:n], non_blocking=True)
        if self.device.type == "cuda":
            self._copied[i] = torch.cuda.Event()
            self._copied[i].record(torch.cuda.current_stream(self.device))

    def to_slot0(self, slot: int) -> None:
        """Copy slot ``slot`` over slot 0 on the device (the graph reads slot 0)."""
        if slot:
            self.buffer[:self.nbytes].copy_(self.buffer[slot * self.nbytes:(slot + 1) * self.nbytes])


class HostCopy:
    """A device tensor's copy into pinned host memory, enqueued on the
    current stream; :meth:`numpy` waits for it. A CPU tensor is copied at once."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type != "cuda":
            self.host = t.detach().clone()
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class SweepGraph:
    """``sweep(state, *feed, lm_loop=...)`` (``pipeline.process_sweep`` with
    its config bound) captured for one window state and one feed, composed
    into one executable graph (``csrc/sweep_graph.cu``).

    The state is copied once into static buffers (:attr:`state`), which each
    replay reads and then overwrites with the new state; ``feed`` are the
    static feed tensors (``FeedBuffer.views[0]``), which the caller fills
    before each replay. :meth:`replay` launches the sweep on the current
    stream and returns its outputs, tensors of the graphs' memory pool that
    the next replay overwrites. A failed capture raises; nothing falls back
    to running the sweep eagerly.
    """

    def __init__(self, sweep, state, feed):
        dev = state.sample.pos.device
        self.device = dev
        self.state = _clone_state(state)
        self.parts = []     # in order: captured graphs, and per LM loop (step, rebuild, flags, max)
        self._current = None
        self._counts0 = None
        self._graph = self._exec = None
        self._iteration = torch.zeros((1,), dtype=torch.int32, device=dev)  # the loops' counter
        self._counter = replay_counter(dev)
        torch.cuda.synchronize(dev)
        reserved0 = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        # a sweep graph dropped earlier (frontends hold theirs in reference
        # cycles) and freed by the collector in the middle of this capture
        # would free its memory pool, which a capture refuses: collect now,
        # and not while capturing
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                # one memory pool for all the graphs: they run one after another
                # on one stream, so a block one frees the next may reuse
                self._pool = torch.cuda.graph_pool_handle()
                self._begin()
                try:
                    new_state, self.outputs = sweep(self.state, *feed, lm_loop=self._capture_loop)
                    _write_back(self.state, new_state)
                finally:
                    # a failed capture is ended too, so that the stream leaves capture mode
                    if self._current is not None:
                        self.parts.append(self._end())
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(dev).wait_stream(stream)
        t1 = time.perf_counter()
        self._compose()
        torch.cuda.synchronize(dev)
        self.capture_seconds = t1 - t0
        self.instantiate_seconds = time.perf_counter() - t1
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved0

    @property
    def graphs(self) -> list:
        """The captured graphs."""
        return [g for part in self.parts
                for g in (part[:2] if isinstance(part, tuple) else (part,))]

    def _begin(self) -> None:
        # keep_graph: the cudaGraph_t stays for the composition (nothing
        # instantiates the captured graphs themselves)
        self._current = torch.cuda.CUDAGraph(keep_graph=True)
        self._current.capture_begin(pool=self._pool)
        self._counts0 = wrapper_counts()

    def _end(self) -> torch.cuda.CUDAGraph:
        g, self._current = self._current, None
        held = wrapper_counts()
        held.subtract(self._counts0)
        for i, k in enumerate(KERNELS):
            if held[k] > 0:  # the launches this graph holds, counted at each replay
                self._counter[i:i + 1].add_(held[k])
        g.capture_end()
        CAPTURED.update(+held)
        return g

    def _capture_loop(self, lm_step, relinearize, max_iterations: int) -> None:
        """The ``lm_loop`` of ``solver.solve_window`` while capturing: end the
        graph before the loop, capture one LM step and one re-linearisation
        as graphs of their own, and go on capturing after the loop."""
        self.parts.append(self._end())
        self._begin()
        flags = lm_step()
        step = self._end()
        self._begin()
        relinearize()
        rebuild = self._end()
        self.parts.append((step, rebuild, flags, max_iterations))
        self._begin()

    def _compose(self) -> None:
        """The captured graphs in order, each LM loop as a device-side WHILE
        node (``csrc/sweep_graph.cu``), instantiated as one graph."""
        lib = _build.library()
        graph, last, exe = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
        _build.check(lib.wc_graph_create(ctypes.byref(graph)), "wc_graph_create")
        self._graph = graph
        for part in self.parts:
            if isinstance(part, tuple):
                step, rebuild, flags, max_iterations = part
                err = lib.wc_graph_add_lm_loop(graph, ctypes.byref(last), step.raw_cuda_graph(),
                                               rebuild.raw_cuda_graph(), flags.data_ptr(),
                                               self._iteration.data_ptr(), max_iterations)
            else:
                err = lib.wc_graph_add_child(graph, ctypes.byref(last), part.raw_cuda_graph())
            # 801, "operation not supported": a captured graph holds a node a
            # child graph cannot, such as a library call's stream-ordered
            # allocation (cuBLAS trsm does that under capture)
            _build.check(err, "composing the sweep graph (wc_graph_add_child/_lm_loop)")
        _build.check(lib.wc_graph_instantiate(graph, ctypes.byref(exe)), "wc_graph_instantiate")
        self._exec = exe

    def replay(self) -> dict:
        """Run the sweep: one launch of the composed graph on the current stream."""
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _build.check(_build.library().wc_graph_launch(self._exec, stream), "wc_graph_launch")
        return self.outputs

    def node_count(self) -> int:
        """Nodes in the captured graphs (the composition adds five a loop)."""
        return sum(_build.graph_nodes(g.raw_cuda_graph()) for g in self.graphs)

    def __del__(self):
        if getattr(self, "_graph", None) is not None and _build._lib is not None:
            _build.library().wc_graph_destroy(self._graph, self._exec)
