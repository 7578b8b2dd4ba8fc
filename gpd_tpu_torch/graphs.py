"""The port's programs as CUDA graphs: the counterpart of jax.jit's caches
of gpd_tpu's programs.

Each device program of the port (``GraspDetector``'s preprocess, detect and
data-generation parts and the sharded ranks' parts, CEM's rounds and
scoring, a trainer's steps) runs through the ``Programs`` of its owner: on
a card as a CUDA graph (``CapturedGraph``) captured at the first call of its
static key and replayed after it, every graph of one owner in one memory
pool; on the CPU, and under the owner's eager switch, as the program
itself. This module alone makes pools and graphs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from gpd_tpu_torch import profiling
from gpd_tpu_torch.ops import _build


def _tensors(tree) -> list:
    """The tensors of a tensor, a dataclass of tensors or a tuple of them
    (None holds none), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _tensors(x)]
    if dataclasses.is_dataclass(tree):
        return _tensors(tuple(getattr(tree, f.name)
                              for f in dataclasses.fields(tree)))
    return []


def clone_tree(tree):
    """A copy of a tensor, a dataclass of tensors or a tuple of them."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        return tuple(clone_tree(x) for x in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: clone_tree(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return tree


class CapturedGraph:
    """``program(generator, *inputs)`` captured as one CUDA graph, with the
    graph's copies of its inputs (``inputs``), the generator it draws from
    and its outputs (``out``): the counterpart of a jitted gpd_tpu program
    compiled for one static key.

    The capture follows PyTorch's recipe: one eager run on a side stream
    first (it builds the kernels, makes every device constant and sets up
    cuBLAS and cuDNN), then the capture into ``pool``, which every graph of
    one owner shares: a ``GraspDetector``'s preprocess, detect and data
    generation programs, a ``SequentialImportanceSampling``'s keys, a
    trainer's steps (``net.train.StepGraphs``). Sharing is safe because
    replays run one at a time on the caller's stream, a graph is captured
    after the graphs whose outputs it reads, while those outputs are alive,
    and what a request keeps of a graph's outputs is copied before any
    other graph replays: detect's and CEM's selections and preprocess's
    cloud are cloned, each preprocess compaction copies its program's
    outputs to the host, a data-generation attempt clones its images and
    hands before its relabelling replays and copies its labels to the host,
    a training step's loss and accuracy are
    cloned. A later capture may so take memory that an earlier graph uses
    only inside its own replay, and the pool holds about one key's working
    set plus the outputs every graph keeps, not the sum of the working
    sets; a data-generation B's images, the one large output, go to a
    buffer outside the pool that every such B shares
    (``GraspDetector._images_buffer``). The raster launchers call
    ``cudaFuncSetAttribute`` and the occupancy query during the capture
    too; neither is a stream operation, and a capture accepts both.

    ``generator`` (on the card, or None for a program that draws nothing)
    is registered with the graph: a replay draws what an eager run from the
    generator's state draws, and advances it as far. The warm-up starts
    from its state and leaves it there. Anything that cannot be captured (a
    read back to the host, a launch error) raises here.

    The kernel wrappers count their launches as always (``_build.LAUNCHES``):
    the warm-up's, and the capture's, which go into the graph
    (``launches``, a ``Counter`` by wrapper name). A replay calls no
    wrapper; what it runs on the card shows in a profiler trace of it.
    ``program`` is kept, and with it what it closes over: a program whose
    key holds ``id(net)`` binds that net, so no other net can take its
    identity while the graph exists (or, as ``net.train.StepGraphs``' eval
    step, reaches it through a weak reference, checked before each
    replay)."""

    def __init__(self, device: torch.device, program, inputs: tuple = (),
                 generator: Optional[torch.Generator] = None, pool=None):
        t0 = time.perf_counter()
        self.program, self.gen = program, generator
        self.inputs = clone_tree(inputs)
        state = None if generator is None else generator.get_state()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            program(generator, *self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            generator.set_state(state)
            self.graph.register_generator_state(generator)
        before = _build.LAUNCHES.copy()
        # torch.cuda.graph empties the allocator's cache first; emptied
        # here, the growth of reserved memory is what the capture adds to
        # the pool.
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = program(generator, *self.inputs)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = _build.LAUNCHES - before
        self.capture_s = time.perf_counter() - t0

    def replay(self, *inputs):
        """``inputs`` (shaped as the capture's) copied into the graph's, one
        replay from the generator's state. Returns the graph's own outputs,
        which the next replay rewrites: a caller clones what it keeps."""
        for dst, src in zip(_tensors(self.inputs), _tensors(inputs)):
            dst.copy_(src)
        self.graph.replay()
        return self.out


class Programs:
    """One owner's programs on ``device``: their CUDA graphs by static key
    (``graphs``), all captured into one memory pool (``pool``, made at the
    first capture), and the keys replayed since the owner last emptied
    ``last_graphs``. A request of seen keys captures nothing. ``eager``, the
    owner's test hook, runs every program eagerly on a card too."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs = {}
        self.pool = None
        self.last_graphs = []
        self.eager = False

    def capture(self, key: tuple, program, inputs: tuple = (),
                generator: Optional[torch.Generator] = None
                ) -> CapturedGraph:
        """``program`` captured into the pool (``CapturedGraph``) as the
        graph of ``key``, in place of any graph the key had."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = self.graphs[key] = CapturedGraph(self.device, program,
                                                 inputs, generator, self.pool)
        return graph

    def run(self, key: tuple, program, inputs: tuple = (),
            generator: Optional[torch.Generator] = None,
            capture_span: str = "detect_capture"):
        """``program(generator, *inputs)``: eagerly on the CPU and under
        ``eager``, recording nothing; on a card a replay of the graph of
        ``key``, captured first (in the span ``capture_span``) if the key is
        new, its outputs the graph's own, which its next replay rewrites;
        the key goes on ``last_graphs``.

        A program that draws gets ``generator``. On a card its graph draws
        from a generator of its own, registered with it at its capture:
        ``generator``'s state is copied into that generator before the
        replay and back out after it, so a replay draws what an eager run
        from ``generator`` draws and leaves ``generator`` where that run
        would. A generator on another device is refused."""
        if self.device.type != "cuda" or self.eager:
            return program(generator, *inputs)
        graph = self.graphs.get(key)
        private = None
        if generator is not None:
            if generator.device.type != "cuda":
                raise ValueError(f"the program {key[0]!r} draws on "
                                 f"{self.device}: its generator must draw on "
                                 f"it, not on {generator.device}")
            private = (graph.gen if graph is not None
                       else torch.Generator(device=self.device))
            private.set_state(generator.get_state())
        if graph is None:
            with profiling.span(capture_span):
                graph = self.capture(key, program, inputs, private)
        self.last_graphs.append(key)
        out = graph.replay(*inputs)
        if private is not None:
            generator.set_state(private.get_state())
        return out
