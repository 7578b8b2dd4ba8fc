"""gpd_tpu_torch's LeNet against gpd_tpu.net.lenet on the CPU (float32 on
both sides): the packaged 15- and 3-channel checkpoints carried across with
params_from_numpy, the 3-fc NetCCFFF variant and the conv-without-ReLU
(Eigen backend) forward, scores within 2e-4."""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpd_tpu.net import lenet as jlenet
from gpd_tpu_torch.net import lenet
from test_torch_threads import set_cpu_share

set_cpu_share()


def images(channels, n=6, seed=0):
    rng = np.random.default_rng(seed + channels)
    return rng.integers(0, 256, size=(n, 60, 60, channels)).astype(np.uint8)


@pytest.mark.parametrize("channels", [15, 3])
def test_packaged_checkpoint_scores(channels):
    path = lenet.default_params_path(channels)
    params = lenet.load_params_npz(path)
    x = images(channels)
    ref = np.asarray(jlenet.score(jlenet.load_params_npz(
        jlenet.default_params_path(channels)), jnp.asarray(x)))
    net = lenet.params_from_numpy(params, device="cpu")
    out = lenet.score(net, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4)
    assert out.dtype == np.float32 and out.shape == (6,)


@pytest.mark.parametrize("variant", ["ccfff", "no_conv_relu"])
def test_variants(variant):
    key = jax.random.PRNGKey(1)
    if variant == "ccfff":
        params = jlenet.init_params_ccfff(key, 15)
        conv_relu = True
    else:
        params = jlenet.init_params(key, 15)
        conv_relu = False
    x = images(15, seed=4)
    ref = np.asarray(jlenet.forward(params, jnp.asarray(x),
                                    conv_relu=conv_relu))
    net = lenet.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                  device="cpu", conv_relu=conv_relu)
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-5)


def test_module_layout():
    net = lenet.params_from_numpy(
        lenet.load_params_npz(lenet.default_params_path(15)), device="cpu")
    assert isinstance(net, torch.nn.Module) and not net.training
    assert [fc.out_features for fc in net.fcs] == [500, 2]
    assert net.conv1.weight.shape == (20, 15, 5, 5)


@pytest.mark.parametrize("channels", [1, 3, 12, 15])
def test_init_params_shapes_and_scales(channels):
    """init_params has gpd_tpu's names and shapes, zero biases, and He
    weights: each weight's std within 10% of sqrt(2 / fan_in)."""
    ours = lenet.init_params(torch.Generator().manual_seed(channels),
                             channels, 60)
    theirs = jlenet.init_params(jax.random.PRNGKey(0), channels, 60)
    assert {k: v.shape for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    for name, w in ours.items():
        assert w.dtype == np.float32
        if name.endswith("_b"):
            assert not w.any()
            continue
        fan_in = int(np.prod(w.shape[1:]))
        assert abs(w.std() / np.sqrt(2.0 / fan_in) - 1) < 0.1, name
    net = lenet.params_from_numpy(ours, device="cpu")
    assert net.conv1.in_channels == channels
    x = torch.from_numpy(images(channels, n=2))
    assert torch.isfinite(lenet.score(net, x)).all()


def test_bf16_logits_are_f32_products_of_rounded_operands():
    """At compute_dtype=bfloat16 (the card's default) the logits are float32,
    and the last layer is the float32 product of bf16-rounded operands plus
    the float32 bias (gpd_tpu's dense, lenet.py:112-116), to 1e-6 of a
    float64 evaluation of the same rounded operands."""
    net = lenet.params_from_numpy(
        lenet.load_params_npz(lenet.default_params_path(15)), device="cpu")
    calls = []
    linear = torch.nn.functional.linear

    def spy(x, w, b=None):
        calls.append((x, w, b))
        return linear(x, w, b)
    x = torch.from_numpy(images(15, n=32, seed=2))
    with mock.patch.object(lenet.F, "linear", spy), torch.no_grad():
        logits = net(x, torch.bfloat16)
    assert logits.dtype == torch.float32 and logits.shape == (32, 2)
    h, w, b = calls[-1]
    for operand in (h, w):
        assert operand.dtype == torch.float32
        assert torch.equal(operand, operand.to(torch.bfloat16).float())
    assert torch.equal(b, net.fcs[-1].bias)
    ref = (h.double() @ w.double().T + b.double()).detach()
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=0,
                               atol=1e-6)


def test_bf16_scores_against_gpd_tpu():
    """The packaged 15-channel checkpoint at bfloat16 on both sides: scores
    within 2e-2 of gpd_tpu's forward(compute_dtype=bfloat16) (the two
    round the same operands; accumulation orders differ, and an operand
    near a bf16 boundary rounds to either side), and no fewer distinct
    scores than gpd_tpu's. The float32 forward stays within 2e-4."""
    params = lenet.load_params_npz(lenet.default_params_path(15))
    x = images(15, n=256, seed=3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref = np.asarray(jlenet.forward(jp, jnp.asarray(x),
                                    compute_dtype=jnp.bfloat16))
    net = lenet.params_from_numpy(params, device="cpu")
    out = lenet.score(net, torch.from_numpy(x), torch.bfloat16).numpy()
    ref_score = ref[:, 1] - ref[:, 0]
    assert out.dtype == np.float32
    assert np.abs(out - ref_score).max() < 2e-2
    assert len(np.unique(out)) >= len(np.unique(ref_score))
    f32 = lenet.score(net, torch.from_numpy(x)).numpy()
    ref32 = np.asarray(jlenet.score(jp, jnp.asarray(x)))
    np.testing.assert_allclose(f32, ref32, atol=2e-4)
