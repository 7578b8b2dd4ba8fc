"""The plain reference of training steps: GPD's LeNet written out as
functions of its parameter tensors (conv 5x5 -> ReLU -> max pool 2, twice,
then fc -> ReLU -> fc, on the image scaled by 1/256, mean softmax
cross-entropy), in float32 with TF32 off, stepped by Adam written out:
the L2 term added to the gradient before the moments (train_net3.py:
100-103), betas (0.9, 0.999), eps 1e-8, bias-corrected.

It starts from a state it is given: the parameters, and the moments and
step count of a run already under way, as the program held them at that
step (``State``). From that state it takes the rows of the next steps as
the program's shuffle draws them and follows three steps. A control runs
the same with TF32 on; the half-batch fault with half of each batch.

``compare`` takes each number by the worst leaf, as the gap between the
program's norm and the reference's, over the reference's norm of that leaf
or of the median leaf, whichever is larger."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.serve import tf32

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
# Leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone under Adam; their change is not compared.
STILL_LEAF = 1e-3


@dataclasses.dataclass
class State:
    """Parameters in layer order (conv1 w, b, conv2 w, b, fc1 w, b, fc2 w,
    b), Adam's first and second moments (None before the first step) and
    its step count."""
    params: List[torch.Tensor]
    m: Optional[List[torch.Tensor]] = None
    v: Optional[List[torch.Tensor]] = None
    t: int = 0

    def clone(self) -> "State":
        def c(xs):
            return None if xs is None else [x.detach().clone() for x in xs]
        return State(c(self.params), c(self.m), c(self.v), self.t)


def logits(p: List[torch.Tensor], images_u8: torch.Tensor) -> torch.Tensor:
    x = images_u8.permute(0, 3, 1, 2).float() / 256.0
    x = F.max_pool2d(F.relu(F.conv2d(x, p[0], p[1])), 2)
    x = F.max_pool2d(F.relu(F.conv2d(x, p[2], p[3])), 2)
    x = F.relu(F.linear(x.flatten(1), p[4], p[5]))
    return F.linear(x, p[6], p[7])


def steps(state: State, images: torch.Tensor, labels: torch.Tensor,
          batches: List[np.ndarray], mix: dict, tf32_on: bool = False
          ) -> Dict[str, object]:
    """Steps from ``state`` on ``images[b]`` for each batch ``b``: each
    step's loss, the first step's gradient with its decay term (as Adam
    takes it), and the parameters before and after."""
    s = state.clone()
    lr, wd = mix["lr"], mix["weight_decay"]
    if s.m is None:
        s.m = [torch.zeros_like(x) for x in s.params]
        s.v = [torch.zeros_like(x) for x in s.params]
    out = {"params0": [x.clone() for x in s.params]}
    with tf32(tf32_on):
        for k, b in enumerate(batches, 1):
            idx = torch.as_tensor(b, device=images.device)
            p = [x.detach().requires_grad_(True) for x in s.params]
            loss = F.cross_entropy(logits(p, images[idx]),
                                   labels[idx].long())
            grads = torch.autograd.grad(loss, p)
            s.t += 1
            new = []
            for i, (x, g) in enumerate(zip(s.params, grads)):
                g = g + wd * x
                if k == 1:
                    out.setdefault("grad1", []).append(g.detach().clone())
                s.m[i] = BETA1 * s.m[i] + (1 - BETA1) * g
                s.v[i] = BETA2 * s.v[i] + (1 - BETA2) * g * g
                mh = s.m[i] / (1 - BETA1 ** s.t)
                vh = s.v[i] / (1 - BETA2 ** s.t)
                new.append((x - lr * mh / (vh.sqrt() + EPS)).detach())
            s.params = new
            out[f"loss{k}"] = loss.detach()
    out["params3"] = s.params
    return out


def _leaf_gap(got: List[torch.Tensor], ref: List[torch.Tensor],
              keep=None) -> float:
    g = [float(t.double().norm()) for t in got]
    r = [float(t.double().norm()) for t in ref]
    med = float(np.median(r))
    idx = range(len(r)) if keep is None else keep
    return max((abs(g[i] - r[i]) / max(r[i], med) for i in idx), default=0.0)


def compare(got: Dict[str, object], ref: Dict[str, object]) -> dict:
    """loss_gap: the widest relative gap of the three losses; grad_gap
    (where both give the first gradient): the first gradient by the worst
    leaf; update_gap: the parameters' change over the three steps by the
    worst leaf, leaves that are still in the reference (STILL_LEAF) left
    out."""
    loss_gap = max(abs(float(got[f"loss{k}"]) - float(ref[f"loss{k}"]))
                   / abs(float(ref[f"loss{k}"])) for k in (1, 2, 3))
    g_norms = [float(t.double().norm()) for t in ref["grad1"]]
    med = float(np.median(g_norms))
    moving = [i for i, n in enumerate(g_norms) if n >= STILL_LEAF * med]
    p0 = ref["params0"]
    d_got = [a - b for a, b in zip(got["params3"], p0)]
    d_ref = [a - b for a, b in zip(ref["params3"], p0)]
    out = dict(loss_gap=loss_gap, update_gap=_leaf_gap(d_got, d_ref, moving))
    if "grad1" in got:
        out["grad_gap"] = _leaf_gap(got["grad1"], ref["grad1"])
    return out


def init_gap(params: List[torch.Tensor]) -> float:
    """How far an initial state lies from the stated initialisation,
    N(0, 2 / fan_in) weights and zero biases: the widest of each weight
    leaf's |std / sqrt(2 / fan_in) - 1| and |bias|."""
    gap = 0.0
    for w, b in zip(params[0::2], params[1::2]):
        fan = int(np.prod(w.shape[1:]))
        gap = max(gap, abs(float(w.double().std()) / np.sqrt(2.0 / fan) - 1),
                  float(b.abs().max()))
    return gap
