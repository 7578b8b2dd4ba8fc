"""LeNet grasp classifier (port of gpd_tpu/net/lenet.py:88-160,192-203).

    conv(C->20, 5x5) -> maxpool2 -> conv(20->50, 5x5) -> maxpool2
    -> fc(7200->500) -> ReLU -> fc(500->2)

(pytorch/network.py:32-47 of the reference), or the 3-fc NetCCFFF variant
(network.py:13-30) when the checkpoint has ``fc3_w``. ReLU follows each
conv as in the training network; ``conv_relu=False`` reproduces the
reference's Eigen backend. Score = logit(positive) - logit(negative)
(eigen_classifier.cpp:74). Inputs are uint8 (G, H, W, C) images scaled by
1/256 (pytorch/hdf5_dataset.py:18).

``compute_dtype`` is the operand type of the convolutions and products,
as in gpd_tpu's ``forward`` (lenet.py:142-160): bfloat16 on the card and
float32 on the CPU unless named. The logits are float32 either way: at
bfloat16 every dense layer after fc1 takes bf16-rounded operands and forms
its products and bias in float32, gpd_tpu's ``dense`` with
``preferred_element_type=float32`` (lenet.py:112-116). A product of two
bf16 values is exact in float32, so with TF32 off this is gpd_tpu's
arithmetic. On the card the convolutions and fc1 run under bf16 autocast
(cuDNN and cuBLAS, float32 accumulation); their bf16 outputs round where
gpd_tpu rounds the next layer's operands. On the CPU every layer takes
rounded operands in float32. Training runs float32 on every device.

Weights load from every format gpd_tpu reads (``load_params``, lenet.py:
163-252), as gpd_tpu's parameter dict of float32 numpy arrays.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gpd_tpu_torch import resolve_device
from gpd_tpu_torch.net import onnx_io


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

    def forward(self, images_u8: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(G, H, W, C) uint8 -> (G, 2) float32 logits; ``compute_dtype``
        bfloat16 on the card and float32 on the CPU unless named."""
        if compute_dtype is None:
            compute_dtype = (torch.bfloat16 if images_u8.is_cuda
                             else torch.float32)
        low = compute_dtype != torch.float32
        amp = low and images_u8.is_cuda

        def rnd(t):
            """An operand rounded to compute_dtype, held in float32 (autocast
            rounds on the card)."""
            return t.to(compute_dtype).float() if low and not amp else t

        x = images_u8.permute(0, 3, 1, 2).to(torch.float32) * (1.0 / 256.0)
        with torch.autocast("cuda", dtype=compute_dtype, enabled=amp):
            for conv in (self.conv1, self.conv2):
                x = F.conv2d(rnd(x), rnd(conv.weight), conv.bias)
                if self.conv_relu:
                    x = F.relu(x)
                x = F.max_pool2d(x, 2)
            x = x.flatten(1)
            fc1 = self.fcs[0]
            x = F.linear(rnd(x), rnd(fc1.weight), fc1.bias)
        for fc in self.fcs[1:]:
            x = F.relu(x).float()
            if low:
                x = x.to(compute_dtype).float()
            w = fc.weight.to(compute_dtype).float() if low else fc.weight
            x = F.linear(x, w, fc.bias)
        return x


def score(net: LeNet, images_u8: torch.Tensor,
          compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Grasp score = positive - negative logit (eigen_classifier.cpp:74)."""
    with torch.no_grad():
        logits = net(images_u8, compute_dtype)
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


def params_to_numpy(net: LeNet) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy``: gpd_tpu's parameter dict of
    float32 numpy arrays, from a LeNet on any device."""
    p = {"conv1_w": net.conv1.weight, "conv1_b": net.conv1.bias,
         "conv2_w": net.conv2.weight, "conv2_b": net.conv2.bias}
    for i, fc in enumerate(net.fcs, start=1):
        p[f"fc{i}_w"], p[f"fc{i}_b"] = fc.weight, fc.bias
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in p.items()}


def _he_tower(generator: torch.Generator, num_channels: int,
              image_size: int, fc_widths: Tuple[int, ...]
              ) -> Dict[str, np.ndarray]:
    """N(0, 2/fan_in) weights drawn from ``generator`` in layer order (conv1,
    conv2, fc1, ...) and zero biases; fc widths end with the 2 logits."""
    s = ((image_size - 4) // 2 - 4) // 2
    shapes = {"conv1": (20, num_channels, 5, 5), "conv2": (50, 20, 5, 5)}
    fan_in = 50 * s * s
    for i, width in enumerate(fc_widths, start=1):
        shapes[f"fc{i}"] = (width, fan_in)
        fan_in = width
    out = {}
    for name, shape in shapes.items():
        w = torch.randn(shape, generator=generator, device=generator.device)
        w = w * np.sqrt(2.0 / int(np.prod(shape[1:])))
        out[f"{name}_w"] = w.cpu().numpy()
        out[f"{name}_b"] = np.zeros(shape[0], np.float32)
    return out


def init_params(generator: torch.Generator, num_channels: int = 15,
                image_size: int = 60) -> Dict[str, np.ndarray]:
    """He-style random init of the LeNet tower (gpd_tpu/net/lenet.py:37-57):
    the same names, shapes and scales, drawn from ``generator`` (torch's
    numbers, not JAX's). Returns float32 numpy arrays, as
    ``load_params_npz`` does."""
    return _he_tower(generator, num_channels, image_size, (500, 2))


def init_params_ccfff(generator: torch.Generator, num_channels: int = 15,
                      image_size: int = 60,
                      hidden: Tuple[int, int] = (120, 84)
                      ) -> Dict[str, np.ndarray]:
    """The reference's NetCCFFF 3-fc variant (pytorch/network.py:13-30;
    gpd_tpu/net/lenet.py:60-84): conv-conv-fc-fc-fc with an extra hidden
    layer, initialized as ``init_params``."""
    return _he_tower(generator, num_channels, image_size, (*hidden, 2))


# The raw-float32 file of each parameter in a .bin directory.
BIN_NAMES = {"conv1_w": "conv1_weights.bin", "conv1_b": "conv1_biases.bin",
             "conv2_w": "conv2_weights.bin", "conv2_b": "conv2_biases.bin",
             "fc1_w": "ip1_weights.bin", "fc1_b": "ip1_biases.bin",
             "fc2_w": "ip2_weights.bin", "fc2_b": "ip2_biases.bin"}


def load_params_bin(params_dir: str, num_channels: int = 15
                    ) -> Dict[str, np.ndarray]:
    """The reference's raw-float32 weight files (eigen_classifier.cpp:28-50,
    185-204; gpd_tpu/net/lenet.py:163-189): caffe (O, I, KH, KW) convs and
    (out, in) fc weights over a CHW flatten, one file each. A missing file
    raises FileNotFoundError, a wrong size ValueError."""
    shapes = {"conv1_w": (20, num_channels, 5, 5), "conv1_b": (20,),
              "conv2_w": (50, 20, 5, 5), "conv2_b": (50,),
              "fc1_w": (500, 50 * 12 * 12), "fc1_b": (500,),
              "fc2_w": (2, 500), "fc2_b": (2,)}
    out = {}
    for key, shape in shapes.items():
        name = BIN_NAMES[key]
        arr = np.fromfile(os.path.join(params_dir, name), dtype=np.float32)
        expect = int(np.prod(shape))
        if arr.size != expect:
            raise ValueError(f"{name}: got {arr.size} floats, want {expect}")
        out[key] = arr.reshape(shape)
    return out


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """gpd_tpu's npz checkpoints (possibly stored float16) as float32
    numpy arrays."""
    with np.load(path) as data:
        return {k: data[k].astype(np.float32) for k in data.files}


def default_params_path(num_channels: int) -> str:
    """The packaged trained checkpoint for a channel count: the port's own
    copy in ``gpd_tpu_torch/models``, byte for byte gpd_tpu's (written by
    ``tools.train_classifier`` in gpd_tpu's key names)."""
    return os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "models", f"lenet_{num_channels}ch.npz")


def save_params_npz(path: str, params: Dict[str, np.ndarray]) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


# State-dict names of the reference's torch Net, against gpd_tpu's.
TORCH_NAMES = {"conv1.weight": "conv1_w", "conv1.bias": "conv1_b",
                "conv2.weight": "conv2_w", "conv2.bias": "conv2_b",
                "fc1.weight": "fc1_w", "fc1.bias": "fc1_b",
                "fc2.weight": "fc2_w", "fc2.bias": "fc2_b"}


def load_params_torch(path: str) -> Dict[str, np.ndarray]:
    """A pytorch Net state_dict checkpoint (train_net3.py:154-174;
    gpd_tpu/net/lenet.py:210-227), DataParallel's "module." prefixes
    stripped. Only tensors are unpickled (``weights_only``), so a file that
    pickles a whole module raises, as in gpd_tpu under this torch."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    return {ours: sd[theirs].numpy().astype(np.float32)
            for theirs, ours in TORCH_NAMES.items()}


def load_params(weights_file: str, num_channels: int = 15
                ) -> Dict[str, np.ndarray]:
    """Dispatch on ``weights_file`` as the reference's classifier factory
    (classifier.cpp:17-33) and gpd_tpu (lenet.py:230-252) do: a directory
    -> raw .bin files; .npz; .pt/.pth/.pwf/.model -> torch; .onnx -> ONNX
    initializers; .xml -> OpenVINO IR (+ sibling .bin); empty -> random
    init from a generator seeded with 0. Anything else raises ValueError."""
    if not weights_file:
        return init_params(torch.Generator().manual_seed(0), num_channels)
    if os.path.isdir(weights_file):
        return load_params_bin(weights_file, num_channels)
    ext = os.path.splitext(weights_file)[1].lower()
    if ext == ".npz":
        return load_params_npz(weights_file)
    if ext in (".pt", ".pth", ".pwf", ".model"):
        return load_params_torch(weights_file)
    if ext == ".onnx":
        return onnx_io.load_params_onnx(weights_file)
    if ext == ".xml":
        return onnx_io.load_params_openvino(weights_file)
    raise ValueError(f"Unrecognized weights file: {weights_file}")
