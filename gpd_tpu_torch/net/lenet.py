"""LeNet grasp classifier (port of gpd_tpu/net/lenet.py:88-160,192-203).

    conv(C->20, 5x5) -> maxpool2 -> conv(20->50, 5x5) -> maxpool2
    -> fc(7200->500) -> ReLU -> fc(500->2)

(pytorch/network.py:32-47 of the reference), or the 3-fc NetCCFFF variant
(network.py:13-30) when the checkpoint has ``fc3_w``. ReLU follows each
conv as in the training network; ``conv_relu=False`` reproduces the
reference's Eigen backend. Score = logit(positive) - logit(negative)
(eigen_classifier.cpp:74). Inputs are uint8 (G, H, W, C) images scaled by
1/256 (pytorch/hdf5_dataset.py:18).

On the card the convolutions and products run in bfloat16 with float32
accumulation, as gpd_tpu does on an accelerator; on the CPU they stay
float32.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gpd_tpu_torch import resolve_device


class LeNet(nn.Module):
    """NCHW LeNet whose fc layers take a CHW flatten, the caffe layout of
    gpd_tpu's checkpoints (lenet.py:126-131)."""

    def __init__(self, num_channels: int = 15, image_size: int = 60,
                 hidden=(500,), conv_relu: bool = True):
        super().__init__()
        s = ((image_size - 4) // 2 - 4) // 2
        self.conv_relu = conv_relu
        self.conv1 = nn.Conv2d(num_channels, 20, 5)
        self.conv2 = nn.Conv2d(20, 50, 5)
        widths = [50 * s * s, *hidden, 2]
        self.fcs = nn.ModuleList(nn.Linear(a, b)
                                 for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        """(G, H, W, C) uint8 -> (G, 2) float32 logits."""
        x = images_u8.permute(0, 3, 1, 2).to(torch.float32) * (1.0 / 256.0)
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=x.device.type == "cuda"):
            x = self.conv1(x)
            if self.conv_relu:
                x = F.relu(x)
            x = F.max_pool2d(x, 2)
            x = self.conv2(x)
            if self.conv_relu:
                x = F.relu(x)
            x = F.max_pool2d(x, 2).flatten(1)
            for i, fc in enumerate(self.fcs):
                if i > 0:
                    x = F.relu(x)
                x = fc(x)
        return x.float()


def score(net: LeNet, images_u8: torch.Tensor) -> torch.Tensor:
    """Grasp score = positive - negative logit (eigen_classifier.cpp:74)."""
    with torch.no_grad():
        logits = net(images_u8)
    return logits[:, 1] - logits[:, 0]


def params_from_numpy(params: Dict[str, np.ndarray], device=None,
                      conv_relu: bool = True) -> LeNet:
    """A LeNet on ``device`` (CUDA unless named) holding gpd_tpu's
    parameter dict: caffe-layout OIHW convs, (out, in) fc weights over a
    CHW flatten, names conv{1,2}_{w,b} and fc{1,2[,3]}_{w,b}. The image
    size follows from fc1's width (50 x s x s after two conv-pool steps)."""
    device = resolve_device(device)
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    C = p["conv1_w"].shape[1]
    s = int(round((p["fc1_w"].shape[1] / 50) ** 0.5))
    image_size = (s * 2 + 4) * 2 + 4
    n_fc = 3 if "fc3_w" in p else 2
    hidden = tuple(p[f"fc{i}_w"].shape[0] for i in range(1, n_fc))
    net = LeNet(C, image_size, hidden, conv_relu)
    sd = {"conv1.weight": p["conv1_w"], "conv1.bias": p["conv1_b"],
          "conv2.weight": p["conv2_w"], "conv2.bias": p["conv2_b"]}
    for i in range(n_fc):
        sd[f"fcs.{i}.weight"] = p[f"fc{i + 1}_w"]
        sd[f"fcs.{i}.bias"] = p[f"fc{i + 1}_b"]
    net.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return net.to(device).eval()


def init_params(generator: torch.Generator, num_channels: int = 15,
                image_size: int = 60) -> Dict[str, np.ndarray]:
    """He-style random init of the LeNet tower (gpd_tpu/net/lenet.py:37-57):
    the same names, shapes and scales, N(0, 2/fan_in) weights and zero
    biases, drawn from ``generator`` (torch's numbers, not JAX's). Returns
    float32 numpy arrays, as ``load_params_npz`` does."""
    s = ((image_size - 4) // 2 - 4) // 2
    flat = 50 * s * s

    def he(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * np.sqrt(2.0 / fan_in)).cpu().numpy()

    zeros = lambda n: np.zeros(n, np.float32)
    return {
        "conv1_w": he((20, num_channels, 5, 5), num_channels * 25),
        "conv1_b": zeros(20),
        "conv2_w": he((50, 20, 5, 5), 20 * 25),
        "conv2_b": zeros(50),
        "fc1_w": he((500, flat), flat),
        "fc1_b": zeros(500),
        "fc2_w": he((2, 500), 500),
        "fc2_b": zeros(2),
    }


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """gpd_tpu's npz checkpoints (possibly stored float16) as float32
    numpy arrays."""
    with np.load(path) as data:
        return {k: data[k].astype(np.float32) for k in data.files}


def default_params_path(num_channels: int) -> str:
    """The packaged trained checkpoint for a channel count. It is a data
    file of the JAX package, read by path; the port imports nothing of it."""
    return os.path.join(os.path.dirname(__file__), "..", "..", "gpd_tpu",
                        "models", f"lenet_{num_channels}ch.npz")
