"""gpd_tpu_torch: grasp pose detection in PyTorch and CUDA for NVIDIA Hopper.

The port of the JAX package ``gpd_tpu`` (which stays the reference): the
same modules under the same names, plain PyTorch tensor code, and a CUDA
kernel written by hand wherever ``gpd_tpu`` has a Pallas kernel.

Geometry runs in full float32. Importing the package turns TF32 off for
matrix products and cuDNN convolutions, once for the process: TF32 keeps
about three decimal digits, which flips the hand-frame containment tests
(the port's form of gpd_tpu's ``Precision.HIGHEST`` rule). Only the CNN runs
in bfloat16, and only on the card (``net/lenet.py``).
"""

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises instead of quietly running on the CPU when there is no
    CUDA device and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gpd_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


_CONSTANTS = {}


def constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """``values`` (an array or nested sequence made on the host) as a tensor
    on ``device``, made once per (values, dtype, device) and shared by every
    later call, which copies nothing. A copy from the host waits for the
    card, which CUDA graph capture forbids: code that a graph captures takes
    its constants from here, and the eager run before the capture has made
    them. Callers never write to the result."""
    a = np.asarray(values, dtype=np.float64)
    key = (a.tobytes(), a.shape, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.from_numpy(a).to(device=device,
                                                     dtype=dtype)
    return t
