"""Classifier training (port of gpd_tpu/net/train.py; the reference's
pytorch/train_net3.py): Adam lr 1e-3 with L2 weight decay 5e-4 added to the
gradient before the moments, mean softmax cross-entropy, batch 64,
block-wise HDF5 loading, evaluation and a checkpoint per block.

Training runs at float32 on every device (``LeNet.forward(compute_dtype=
float32)``), as gpd_tpu's ``loss_fn`` does; TF32 is off for the whole
package. ``fit`` takes any object with ``blocks()`` (yielding (images
(N, s, s, C) uint8, labels (N,) int) pairs), so it runs without a file;
``train`` is ``fit`` over ``HDF5Dataset``s. gpd_tpu's data-parallel mesh
over several devices is not ported yet: on one device it is this program.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpd_tpu_torch import resolve_device
from gpd_tpu_torch.net import lenet


def make_optimizer(net: lenet.LeNet, lr: float = 1e-3,
                   weight_decay: float = 5e-4) -> torch.optim.Adam:
    """torch.optim.Adam(lr, weight_decay): the L2 term enters the gradient
    before the Adam moments (train_net3.py:100-103), gpd_tpu's optax
    ``add_decayed_weights`` then ``adam`` (train.py:30-36). Not AdamW."""
    return torch.optim.Adam(net.parameters(), lr=lr,
                            weight_decay=weight_decay)


def loss_fn(net: lenet.LeNet, images_u8: torch.Tensor,
            labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean softmax cross-entropy, logits), both float32."""
    logits = net(images_u8, compute_dtype=torch.float32)
    return F.cross_entropy(logits, labels.long()), logits


def train_step(net: lenet.LeNet, opt: torch.optim.Optimizer,
               images_u8: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step; returns (loss, accuracy) as device scalars, so
    the loop reads them back only when it logs."""
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


def evaluate(net: lenet.LeNet, dataset, batch_size: int = 256
             ) -> Tuple[float, float]:
    """(mean loss, accuracy) over ``dataset.blocks()`` (network.py:66-88),
    the tail batch padded with zeros and weighted out."""
    device = net.conv1.weight.device
    total = correct = 0
    loss_sum = 0.0
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
            loss, c = eval_step(net, *(torch.from_numpy(a).to(device)
                                       for a in (bi, bl.astype(np.int64), w)))
            total += n
            correct += int(c)
            loss_sum += float(loss)
    if total == 0:
        return float("nan"), float("nan")
    return loss_sum / total, correct / total


def fit(dataset, test_dataset, num_channels: int, epochs: int = 10,
        batch_size: int = 64, lr: float = 1e-3, weight_decay: float = 5e-4,
        seed: int = 0, checkpoint_dir: Optional[str] = None,
        eval_every_blocks: int = 1, log_file: Optional[str] = None,
        device=None,
        on_step: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]]
        = None) -> Dict[str, np.ndarray]:
    """The training loop (train_net3.py:60-181; gpd_tpu/net/train.py:
    126-187) over ``dataset.blocks()``: each block moves to the device
    once, is shuffled by gpd_tpu's NumPy permutation (``seed``), and runs in
    full batches; after every ``eval_every_blocks`` blocks, evaluation on
    ``test_dataset`` (if any) and a checkpoint. Starts from
    ``lenet.init_params`` seeded with ``seed`` (torch's numbers). Every
    100th step's (step, loss, accuracy) goes to ``log_file``; ``on_step``,
    if given, gets every step's (step, loss, accuracy), the last two as
    device scalars. Returns the trained parameters as gpd_tpu's dict."""
    device = resolve_device(device)
    net = lenet.params_from_numpy(lenet.init_params(
        torch.Generator().manual_seed(seed), num_channels), device)
    opt = make_optimizer(net, lr, weight_decay)
    rng = np.random.default_rng(seed)
    stats = []

    def save(name):
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
            lenet.save_params_npz(os.path.join(checkpoint_dir, name),
                                  lenet.params_to_numpy(net))

    step = 0
    for epoch in range(epochs):
        t0 = time.time()
        block_i = 0
        for images, labels in dataset.blocks():
            perm = torch.from_numpy(rng.permutation(len(labels))).to(device)
            images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
            labels = torch.from_numpy(labels.astype(np.int64)).to(device)
            for i in range(0, len(perm) - batch_size + 1, batch_size):
                sel = perm[i:i + batch_size]
                loss, acc = train_step(net, opt, images[sel], labels[sel])
                step += 1
                if on_step is not None:
                    on_step(step, loss, acc)
                if step % 100 == 0:
                    stats.append((step, float(loss), float(acc)))
            block_i += 1
            if test_dataset is not None and block_i % eval_every_blocks == 0:
                tl, ta = evaluate(net, test_dataset)
                print(f"epoch {epoch} block {block_i}: test loss {tl:.4f} "
                      f"acc {ta:.4f}")
                save(f"lenet_e{epoch}_b{block_i}.npz")
        print(f"epoch {epoch} done in {time.time() - t0:.1f}s")

    save("lenet_final.npz")
    if log_file and stats:
        with open(log_file, "w") as f:
            for s, l, a in stats:
                f.write(f"{s},{l},{a}\n")
    return lenet.params_to_numpy(net)


def train(train_path: str, test_path: Optional[str], num_channels: int,
          epochs: int = 10, batch_size: int = 64, lr: float = 1e-3,
          weight_decay: float = 5e-4, seed: int = 0,
          checkpoint_dir: Optional[str] = None,
          eval_every_blocks: int = 1, max_in_memory: int = 80000,
          log_file: Optional[str] = None,
          device=None) -> Dict[str, np.ndarray]:
    """``fit`` over HDF5 files (train_net3.py:60-181)."""
    ds = HDF5Dataset(train_path, max_in_memory=max_in_memory)
    test_ds = (HDF5Dataset(test_path, max_in_memory=max_in_memory)
               if test_path else None)
    return fit(ds, test_ds, num_channels, epochs, batch_size, lr,
               weight_decay, seed, checkpoint_dir, eval_every_blocks,
               log_file, device=device)
