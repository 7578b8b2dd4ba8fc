"""Classifier training (port of gpd_tpu/net/train.py; the reference's
pytorch/train_net3.py): Adam lr 1e-3 with L2 weight decay 5e-4 added to the
gradient before the moments, mean softmax cross-entropy, batch 64,
block-wise HDF5 loading, evaluation and a checkpoint per block.

Training runs at float32 on every device (``LeNet.forward(compute_dtype=
float32)``), as gpd_tpu's ``loss_fn`` does; TF32 is off for the whole
package. ``fit`` takes any object with ``blocks()`` (yielding (images
(N, s, s, C) uint8, labels (N,) int) pairs), so it runs without a file;
``train`` is ``fit`` over ``HDF5Dataset``s.

Data parallelism (gpd_tpu's ``dp`` mesh, train.py:134-144): with
``data_parallel=True`` and an initialized process group (one process per
device, ``parallel.multihost.initialize``), ``fit`` wraps the LeNet in
``DistributedDataParallel``, rounds the batch up to at least the world size
and down to a multiple of it, and each rank takes its contiguous slice of
the same permuted batch, so gradients average over the whole batch;
``evaluate`` splits each batch the same way and all-reduces its sums.
Without a process group ``data_parallel`` changes nothing, as gpd_tpu's
with one device.

gpd_tpu jits ``train_step`` (with donation) and ``eval_step``
(train.py:48-65); under a mesh its batches are sharded over ``dp``, so the
gradient reduction is inside the program. Here ``StepGraphs`` is their
counterpart: on a card one CUDA graph per (step, batch shape, net,
optimizer), captured at the first step of its key and replayed, the batch
gathered outside the graph and copied into its inputs; on the CPU the same
bodies eagerly. ``fit`` and ``evaluate`` step through it with and without a
process group. With one, ``fit``'s graph holds the whole DDP step, its
gradient all-reduce included (PyTorch's recipe for capturing a network
under DDP: the wrapper built on a side stream, ``DDP_EAGER_STEPS`` eager
steps before the capture); under gloo, on the CPU, it stays eager.
"""

from __future__ import annotations

import os
import time
import weakref
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from gpd_tpu_torch import profiling, resolve_device
from gpd_tpu_torch.graphs import Programs, clone_tree
from gpd_tpu_torch.net import lenet
from gpd_tpu_torch.parallel import sharded

# DDP's eager steps before its step is captured: it rebuilds its gradient
# buckets after its first iterations, and PyTorch's recipe for capturing a
# network under DDP asks for at least 11.
DDP_EAGER_STEPS = 11


def make_optimizer(net: lenet.LeNet, lr: float = 1e-3,
                   weight_decay: float = 5e-4) -> torch.optim.Adam:
    """torch.optim.Adam(lr, weight_decay): the L2 term enters the gradient
    before the Adam moments (train_net3.py:100-103), gpd_tpu's optax
    ``add_decayed_weights`` then ``adam`` (train.py:30-36). Not AdamW.
    Capturable (its step count on the device, so a CUDA graph can hold the
    step) for a net on a card; the CPU's Adam takes no capturable state."""
    return torch.optim.Adam(net.parameters(), lr=lr,
                            weight_decay=weight_decay,
                            capturable=net.conv1.weight.is_cuda)


def loss_fn(net: torch.nn.Module, images_u8: torch.Tensor,
            labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean softmax cross-entropy, logits), both float32."""
    logits = net(images_u8, compute_dtype=torch.float32)
    return F.cross_entropy(logits, labels.long()), logits


def train_step(net: torch.nn.Module, opt: torch.optim.Optimizer,
               images_u8: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step; returns (loss, accuracy) as device scalars, so
    the loop reads them back only when it logs. ``net`` is a LeNet, or one
    wrapped in ``DistributedDataParallel`` (then the loss and accuracy are
    this rank's slice's)."""
    opt.zero_grad(set_to_none=True)
    loss, logits = loss_fn(net, images_u8, labels)
    loss.backward()
    opt.step()
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    return loss.detach(), acc


def eval_step(net: lenet.LeNet, images_u8: torch.Tensor,
              labels: torch.Tensor, weight: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-example-weighted evaluation, so padded tail batches count
    correctly: (sum of weighted cross-entropy, hits among weight > 0)."""
    with torch.no_grad():
        logits = net(images_u8, compute_dtype=torch.float32)
        ce = F.cross_entropy(logits, labels.long(), reduction="none")
        hit = (logits.argmax(-1) == labels) & (weight > 0)
        return torch.sum(ce * weight), torch.sum(hit.to(torch.int32))


class StepGraphs:
    """``train_step`` and ``eval_step`` as gpd_tpu's jitted programs: on a
    card each replays a CUDA graph (``graphs.Programs.capture``) captured
    at the first step of its key, (step, input shapes and dtypes, the net's
    and the optimizer's identity), all in one pool; on the CPU each runs
    eagerly. A step's inputs are copied into its graph's; its outputs
    come back as copies, so a caller may keep them across steps.

    A capture's warm-up runs one real optimizer step: it is counted as the
    key's first step, whose loss and accuracy it returns, and the graph
    (captured after it, from the state it left) replays the later ones. So
    N steps from given parameters are N optimizer steps, as eagerly. The
    capture sets the gradients to None first (``train_step``'s
    ``zero_grad``), and the graph's backward writes them into the pool,
    PyTorch's whole-network capture recipe; Adam's state, made by the
    warm-up, stays where the graph updates it.

    A net wrapped in ``DistributedDataParallel`` (built on a side stream,
    as ``fit`` builds it) takes ``DDP_EAGER_STEPS`` eager steps first, the
    capture's warm-up the last of them, each a real step as above; the
    graph then holds the backward's all-reduces, which every rank replays
    in the same order."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.programs = Programs(self.device)
        # Weak references to the nets of the eval graphs, by key.
        self._nets = {}
        # The eager steps taken so far by key, for keys that take some
        # before their capture.
        self._eager = {}

    @property
    def graphs(self) -> dict:
        """The steps' CUDA graphs by key."""
        return self.programs.graphs

    def _step(self, key: tuple, program, inputs: tuple, net_ref=None,
              eager_steps: int = 1):
        """``program(*inputs)``: eagerly on the CPU; on a card its outputs,
        copied, from a replay of its graph, or, while ``key`` (with the
        inputs' shapes and dtypes) has taken fewer than ``eager_steps``
        steps, eagerly, the last of them the capture's warm-up. A graph
        whose program reaches its net through ``net_ref``, a weak
        reference, is captured anew once that net is gone: another net may
        then have taken its identity."""
        if self.device.type != "cuda":
            return program(*inputs)
        key = key + tuple((t.shape, t.dtype) for t in inputs)
        ref = self._nets.get(key)
        if key in self.graphs and (ref is None or ref() is not None):
            return clone_tree(self.graphs[key].replay(*inputs))
        done = self._eager.get(key, 0)
        if done + 1 < eager_steps:
            self._eager[key] = done + 1
            return program(*inputs)
        if net_ref is not None:
            self._nets[key] = net_ref
        runs = []

        def record(_, *args):
            runs.append(program(*args))
            return runs[-1]
        self.programs.capture(key, record, inputs)
        return clone_tree(runs[0])      # the warm-up's; runs[1] the graph's

    def train_step(self, net, opt, images_u8: torch.Tensor,
                   labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step (``train_step``): (loss, accuracy)."""
        ddp = isinstance(net, torch.nn.parallel.DistributedDataParallel)
        return self._step(("train", id(net), id(opt)),
                          lambda x, y: train_step(net, opt, x, y),
                          (images_u8, labels),
                          eager_steps=DDP_EAGER_STEPS if ddp else 1)

    def eval_step(self, net, images_u8: torch.Tensor, labels: torch.Tensor,
                  weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``eval_step``: (weighted cross-entropy sum, hits). The graph
        reaches the net through a weak reference, so the ``StepGraphs``
        kept with a net (``net_steps``) does not keep it alive."""
        ref = weakref.ref(net)
        return self._step(("eval", id(net)),
                          lambda x, y, w: eval_step(ref(), x, y, w),
                          (images_u8, labels, weight), ref)


def net_steps(net: lenet.LeNet) -> StepGraphs:
    """The ``StepGraphs`` kept with ``net`` on its device, made at first
    use: an attribute, not a submodule, so it lives as long as the net and
    no longer."""
    device = net.conv1.weight.device
    steps = getattr(net, "_step_graphs", None)
    if steps is None or steps.device != device:
        steps = net._step_graphs = StepGraphs(device)
    return steps


class HDF5Dataset:
    """Block-wise HDF5 loader of the reference's dataset format
    (data_generator.cpp:279-304: 'images' (N, 60, 60, C) uint8, 'labels'
    (N, 1)) with its max-in-memory blocking (train_net3.py:60-96)."""

    def __init__(self, path: str, max_in_memory: int = 80000):
        import h5py
        self.path = path
        self.max_in_memory = max_in_memory
        with h5py.File(path, "r") as f:
            self.n = f["labels"].shape[0]
            self.image_shape = f["images"].shape[1:]

    def blocks(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        import h5py
        with h5py.File(self.path, "r") as f:
            for start in range(0, self.n, self.max_in_memory):
                end = min(start + self.max_in_memory, self.n)
                images = f["images"][start:end]
                labels = f["labels"][start:end].reshape(-1).astype(np.int32)
                yield images, labels


def _dp_mesh(data_parallel: bool) -> Optional[sharded.Mesh]:
    """The data-parallel mesh: the process group, if ``data_parallel`` and
    one is initialized."""
    if data_parallel and dist.is_initialized():
        return sharded.default_mesh()
    return None


def _dp_batch(batch_size: int, mesh: Optional[sharded.Mesh]) -> int:
    """The batch rounded up to at least the world size, then down to a
    multiple of it (gpd_tpu/net/train.py:142-144)."""
    if mesh is None:
        return batch_size
    batch_size = max(batch_size, mesh.size)
    return batch_size - batch_size % mesh.size


def data_parallel_model(net: lenet.LeNet, mesh: sharded.Mesh
                        ) -> torch.nn.parallel.DistributedDataParallel:
    """``net`` in ``DistributedDataParallel`` over the mesh's group, without
    unused-parameter search. On a card it is built on a side stream, as
    PyTorch's recipe for capturing a network under DDP asks. The LeNet has
    no buffers, so DDP's buffer broadcast sends nothing."""
    cuda = mesh.device.type == "cuda"
    side = torch.cuda.Stream(mesh.device) if cuda else None
    if cuda:
        side.wait_stream(torch.cuda.current_stream(mesh.device))
    with torch.cuda.stream(side):        # no-op for None, on the CPU
        model = torch.nn.parallel.DistributedDataParallel(
            net, device_ids=[mesh.device.index] if cuda else None,
            process_group=mesh.group)
    if cuda:
        torch.cuda.current_stream(mesh.device).wait_stream(side)
    return model


def evaluate(net: lenet.LeNet, dataset, batch_size: int = 256,
             mesh: Optional[sharded.Mesh] = None,
             steps: Optional[StepGraphs] = None) -> Tuple[float, float]:
    """(mean loss, accuracy) over ``dataset.blocks()`` (network.py:66-88),
    the tail batch padded with zeros and weighted out. Each batch is a step
    of ``steps`` (by default the ``StepGraphs`` kept with the net,
    ``net_steps``: on a card one graph per padded batch shape, captured at
    the net's first evaluation). With a ``mesh`` (every rank calling, on
    the same data), each rank evaluates its slice of every batch and the
    sums are all-reduced after the loop: every rank returns the whole
    set's numbers."""
    device = net.conv1.weight.device
    step = (steps or net_steps(net)).eval_step
    batch_size = _dp_batch(batch_size, mesh)
    per = batch_size // (1 if mesh is None else mesh.size)
    mine = slice(0, per) if mesh is None else slice(mesh.rank * per,
                                                     (mesh.rank + 1) * per)
    total = 0
    sums = torch.zeros(2, dtype=torch.float64, device=device)
    for images, labels in dataset.blocks():
        for i in range(0, len(labels), batch_size):
            bi = images[i:i + batch_size]
            bl = labels[i:i + batch_size]
            n = len(bl)
            w = np.ones(n, np.float32)
            if n < batch_size:   # pad the tail batch; the weight masks the pad
                pad = batch_size - n
                bi = np.concatenate(
                    [bi, np.zeros((pad,) + bi.shape[1:], bi.dtype)])
                bl = np.concatenate([bl, np.zeros(pad, bl.dtype)])
                w = np.concatenate([w, np.zeros(pad, np.float32)])
            loss, c = step(net, *(torch.from_numpy(a[mine]).to(device)
                                  for a in (bi, bl.astype(np.int64), w)))
            total += n
            sums += torch.stack([loss.double(), c.double()])
    if mesh is not None and mesh.group is not None:
        dist.all_reduce(sums, group=mesh.group)
    if total == 0:
        return float("nan"), float("nan")
    loss_sum, correct = sums.tolist()
    return loss_sum / total, round(correct) / total


def fit(dataset, test_dataset, num_channels: int, epochs: int = 10,
        batch_size: int = 64, lr: float = 1e-3, weight_decay: float = 5e-4,
        seed: int = 0, checkpoint_dir: Optional[str] = None,
        eval_every_blocks: int = 1, log_file: Optional[str] = None,
        device=None,
        on_step: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]]
        = None, data_parallel: bool = True) -> Dict[str, np.ndarray]:
    """The training loop (train_net3.py:60-181; gpd_tpu/net/train.py:
    126-187) over ``dataset.blocks()``: each block moves to the device
    once, is shuffled by gpd_tpu's NumPy permutation (``seed``), and runs in
    full batches; after every ``eval_every_blocks`` blocks, evaluation on
    ``test_dataset`` (if any) and a checkpoint. Starts from
    ``lenet.init_params`` seeded with ``seed`` (torch's numbers). Every
    100th step's (step, loss, accuracy) goes to ``log_file``; ``on_step``,
    if given, gets every step's (step, loss, accuracy), the last two as
    device scalars (with data parallelism, this rank's slice's). Returns the
    trained parameters as gpd_tpu's dict. Steps and evaluation batches go
    through one ``StepGraphs``: on a card CUDA graph replays. A block's
    upload, its steps and each evaluation are the spans ``train_upload``,
    ``train_steps`` and ``train_eval`` (``profiling``).

    ``data_parallel`` with an initialized process group: every rank calls
    ``fit`` on the same data, the device is the rank's (``device`` must name
    its type), steps go through DDP (built on a side stream on a card, so
    that its step can be captured whole, all-reduce included), and only
    rank 0 writes checkpoints and the log."""
    mesh = _dp_mesh(data_parallel)
    device = resolve_device(device)
    if mesh is not None:
        if device.type != mesh.device.type:
            raise ValueError(f"data-parallel training runs on the process "
                             f"group's {mesh.device}, not {device}")
        device = mesh.device
    net = lenet.params_from_numpy(lenet.init_params(
        torch.Generator().manual_seed(seed), num_channels), device)
    model = net
    if mesh is not None:
        model = data_parallel_model(net, mesh)
    opt = make_optimizer(net, lr, weight_decay)
    steps = StepGraphs(device)
    batch_size = _dp_batch(batch_size, mesh)
    per = batch_size if mesh is None else batch_size // mesh.size
    mine = slice(0, per) if mesh is None else slice(mesh.rank * per,
                                                     (mesh.rank + 1) * per)
    lead = mesh is None or mesh.rank == 0
    rng = np.random.default_rng(seed)
    stats = []

    def save(name):
        if checkpoint_dir and lead:
            os.makedirs(checkpoint_dir, exist_ok=True)
            lenet.save_params_npz(os.path.join(checkpoint_dir, name),
                                  lenet.params_to_numpy(net))

    step = 0
    for epoch in range(epochs):
        t0 = time.time()
        block_i = 0
        for images, labels in dataset.blocks():
            with profiling.span("train_upload"):
                perm = torch.from_numpy(
                    rng.permutation(len(labels))).to(device)
                images = torch.from_numpy(
                    np.ascontiguousarray(images)).to(device)
                labels = torch.from_numpy(labels.astype(np.int64)).to(device)
            with profiling.span("train_steps"):
                for i in range(0, len(perm) - batch_size + 1, batch_size):
                    sel = perm[i:i + batch_size][mine]
                    loss, acc = steps.train_step(model, opt, images[sel],
                                                 labels[sel])
                    step += 1
                    if on_step is not None:
                        on_step(step, loss, acc)
                    if step % 100 == 0:
                        both = torch.stack([loss, acc])
                        if mesh is not None:
                            dist.all_reduce(both, group=mesh.group)
                            both /= mesh.size
                        stats.append((step, *both.tolist()))
            block_i += 1
            if test_dataset is not None and block_i % eval_every_blocks == 0:
                with profiling.span("train_eval"):
                    tl, ta = evaluate(net, test_dataset, mesh=mesh,
                                      steps=steps)
                print(f"epoch {epoch} block {block_i}: test loss {tl:.4f} "
                      f"acc {ta:.4f}")
                save(f"lenet_e{epoch}_b{block_i}.npz")
        print(f"epoch {epoch} done in {time.time() - t0:.1f}s")

    save("lenet_final.npz")
    if log_file and stats and lead:
        with open(log_file, "w") as f:
            for s, l, a in stats:
                f.write(f"{s},{l},{a}\n")
    return lenet.params_to_numpy(net)


def train(train_path: str, test_path: Optional[str], num_channels: int,
          epochs: int = 10, batch_size: int = 64, lr: float = 1e-3,
          weight_decay: float = 5e-4, seed: int = 0,
          checkpoint_dir: Optional[str] = None,
          eval_every_blocks: int = 1, max_in_memory: int = 80000,
          log_file: Optional[str] = None, device=None,
          data_parallel: bool = True) -> Dict[str, np.ndarray]:
    """``fit`` over HDF5 files (train_net3.py:60-181)."""
    ds = HDF5Dataset(train_path, max_in_memory=max_in_memory)
    test_ds = (HDF5Dataset(test_path, max_in_memory=max_in_memory)
               if test_path else None)
    return fit(ds, test_ds, num_channels, epochs, batch_size, lr,
               weight_decay, seed, checkpoint_dir, eval_every_blocks,
               log_file, device=device, data_parallel=data_parallel)
