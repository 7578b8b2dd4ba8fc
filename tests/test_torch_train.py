"""gpd_tpu_torch's training (net/train.py, apps/train_net.py) and dataset
tools (apps/hdf5_tools.py) against gpd_tpu's on the CPU.

One training step from the same parameters and batch is held against
gpd_tpu in two parts, because Adam's first update is lr * g / (|g| + eps):
a gradient at rounding-noise level flips the sign of its update. So the
gradients are compared with jax.grad of gpd_tpu's loss_fn, then the
optimizer alone, fed identical gradients, with optax's chain. Evaluation
of a padded tail batch, HDF5 blocks, a short training run and the tools'
outputs follow.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

h5py = pytest.importorskip("h5py")

from gpd_tpu.apps import hdf5_tools as jtools  # noqa: E402
from gpd_tpu.datagen import HDF5ShardWriter as JWriter  # noqa: E402
from gpd_tpu.net import lenet as jlenet  # noqa: E402
from gpd_tpu.net import train as jtrain  # noqa: E402
from gpd_tpu_torch.apps import hdf5_tools, train_net  # noqa: E402
from gpd_tpu_torch.net import lenet, train  # noqa: E402
from test_torch_threads import set_cpu_share  # noqa: E402

set_cpu_share()

NAMES = {"conv1_w": "conv1.weight", "conv1_b": "conv1.bias",
         "conv2_w": "conv2.weight", "conv2_b": "conv2.bias",
         "fc1_w": "fcs.0.weight", "fc1_b": "fcs.0.bias",
         "fc2_w": "fcs.1.weight", "fc2_b": "fcs.1.bias"}


def batch(n, channels, seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 60, 60, channels)).astype(np.uint8)
    return images, rng.integers(0, 2, n).astype(np.int32)


def jparams(channels, seed):
    return {k: np.asarray(v) for k, v in jlenet.init_params(
        jax.random.PRNGKey(seed), channels).items()}


def grads_of(net):
    named = dict(net.named_parameters())
    return {k: named[v].grad.numpy() for k, v in NAMES.items()}


def assert_grads_close(ours, theirs):
    """Each gradient tensor within 1e-4 of its largest entry: float32
    sums over 64 images in other orders, through max-pool selections that
    agree."""
    for k, g in theirs.items():
        g = np.asarray(g)
        np.testing.assert_allclose(ours[k], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


def test_gradients_loss_and_accuracy_match_gpd_tpu():
    """loss_fn's gradients against jax.grad of gpd_tpu's loss_fn; then
    train_step's loss and accuracy against gpd_tpu's train_step within
    1e-5, from the same parameters and batch."""
    params = jparams(3, 0)
    x, y = batch(64, 3, 1)
    (jloss, _), jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(y))
    net = lenet.params_from_numpy(params, device="cpu")
    loss, logits = train.loss_fn(net, torch.from_numpy(x), torch.from_numpy(y))
    assert loss.dtype == logits.dtype == torch.float32
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    assert_grads_close(grads_of(net), jgrads)

    tx = jtrain.make_optimizer(1e-3, 5e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    _, _, jl, ja = jtrain.train_step(jp, tx.init(jp), jnp.asarray(x),
                                     jnp.asarray(y), tx)
    net = lenet.params_from_numpy(params, device="cpu")
    tl, ta = train.train_step(net, train.make_optimizer(net),
                              torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(tl) - float(jl)) < 1e-5
    assert abs(float(ta) - float(ja)) < 1e-5


def test_adam_matches_optax_given_the_same_gradients():
    """make_optimizer (Adam, L2 decay added to the gradient) against optax's
    add_decayed_weights + adam over three steps fed identical gradients:
    parameters within 1e-6."""
    params = jparams(3, 2)
    rng = np.random.default_rng(3)
    grads = [{k: rng.normal(0, 10.0 ** -rng.integers(1, 6), v.shape).astype(
        np.float32) for k, v in params.items()} for _ in range(3)]
    tx = jtrain.make_optimizer(1e-3, 5e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    net = lenet.params_from_numpy(params, device="cpu")
    opt = train.make_optimizer(net, 1e-3, 5e-4)
    named = dict(net.named_parameters())
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in g.items():
            named[NAMES[k]].grad = torch.from_numpy(v)
        opt.step()
    ours = lenet.params_to_numpy(net)
    for k in params:
        np.testing.assert_allclose(ours[k], np.asarray(jp[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


class Blocks:
    """An in-memory dataset: ``blocks()`` yields fixed-size slices."""

    def __init__(self, images, labels, block):
        self.images, self.labels, self.block = images, labels, block

    def blocks(self):
        for i in range(0, len(self.labels), self.block):
            yield self.images[i:i + self.block], self.labels[i:i + self.block]


def test_evaluate_padded_tail_matches_gpd_tpu():
    """evaluate over blocks of 200 at batch 64 (tail batches of 8 and 36
    rows, padded and weighted out): the same hit count and loss (1e-5) as
    gpd_tpu's, and eval_step's per-batch totals on the padded tail."""
    params = jparams(3, 4)
    x, y = batch(300, 3, 5)
    data = Blocks(x, y, 200)
    jloss, jacc = jtrain.evaluate({k: jnp.asarray(v) for k, v in params.items()},
                                  data, batch_size=64)
    net = lenet.params_from_numpy(params, device="cpu")
    loss, acc = train.evaluate(net, data, batch_size=64)
    assert round(acc * 300) == round(jacc * 300)
    assert abs(loss - jloss) < 1e-5
    w = np.concatenate([np.ones(36, np.float32), np.zeros(28, np.float32)])
    xt = np.concatenate([x[-36:], np.zeros((28, 60, 60, 3), np.uint8)])
    yt = np.concatenate([y[-36:], np.zeros(28, np.int32)])
    jl, jh = jtrain.eval_step({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(xt), jnp.asarray(yt), jnp.asarray(w))
    tl, th = train.eval_step(net, torch.from_numpy(xt),
                             torch.from_numpy(yt.astype(np.int64)),
                             torch.from_numpy(w))
    assert int(th) == int(jh)
    assert abs(float(tl) - float(jl)) < 1e-4


def learnable_shard(path, n, channels, seed):
    """A shard whose label is whether channel 0 is bright."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n).astype(np.uint8)
    images = rng.integers(0, 96, (n, 60, 60, channels)).astype(np.uint8)
    images[labels == 1, :, :, 0] += 128
    w = JWriter(path, 60, channels)
    w.append("o", 0, images, labels)
    w.close()
    return images, labels


def test_hdf5_dataset_blocks_match_gpd_tpu(tmp_path):
    path = str(tmp_path / "d.h5")
    learnable_shard(path, 70, 3, 6)
    ours = list(train.HDF5Dataset(path, max_in_memory=32).blocks())
    theirs = list(jtrain.HDF5Dataset(path, max_in_memory=32).blocks())
    assert [len(b[1]) for b in ours] == [32, 32, 6]
    for (oi, ol), (ti, tl) in zip(ours, theirs):
        assert oi.dtype == ti.dtype and ol.dtype == tl.dtype == np.int32
        np.testing.assert_array_equal(oi, ti)
        np.testing.assert_array_equal(ol, tl)
    assert train.HDF5Dataset(path).image_shape == (60, 60, 3)


def test_short_train_lowers_the_loss(tmp_path):
    """train on a 320-row shard, 3 epochs at batch 64: the test loss falls
    below the initial parameters', a checkpoint per block and a final one
    are written, and on_step sees every step."""
    tr, te = str(tmp_path / "train.h5"), str(tmp_path / "test.h5")
    learnable_shard(tr, 320, 3, 7)
    learnable_shard(te, 100, 3, 8)
    init = lenet.init_params(torch.Generator().manual_seed(0), 3)
    before, _ = train.evaluate(lenet.params_from_numpy(init, "cpu"),
                               train.HDF5Dataset(te))
    steps = []
    trained = train.fit(train.HDF5Dataset(tr), train.HDF5Dataset(te), 3,
                        epochs=3, checkpoint_dir=str(tmp_path / "ck"),
                        device="cpu", on_step=lambda s, l, a: steps.append(
                            float(l)))
    after, acc = train.evaluate(lenet.params_from_numpy(trained, "cpu"),
                                train.HDF5Dataset(te))
    assert len(steps) == 15 and after < before and acc > 0.5
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "lenet_e0_b1.npz", "lenet_e1_b1.npz", "lenet_e2_b1.npz",
        "lenet_final.npz"]
    final = lenet.load_params_npz(str(tmp_path / "ck" / "lenet_final.npz"))
    for k in trained:
        np.testing.assert_array_equal(final[k], trained[k])
    again = train.train(tr, te, 3, epochs=3, device="cpu")
    for k in trained:
        np.testing.assert_array_equal(again[k], trained[k])


def test_train_net_cli(tmp_path, monkeypatch, capsys):
    tr, te = str(tmp_path / "train.h5"), str(tmp_path / "test.h5")
    learnable_shard(tr, 130, 3, 9)
    learnable_shard(te, 40, 3, 10)
    monkeypatch.chdir(tmp_path)
    assert train_net.main([tr, te], device="cpu") == -1
    assert train_net.main([tr, te, "3", "1", "ck"], device="cpu") == 0
    assert "epoch 0 block 1: test loss" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "ck" / "lenet_final.npz")


@pytest.fixture
def dataset(tmp_path):
    path = str(tmp_path / "in.h5")
    rng = np.random.default_rng(1)
    with h5py.File(path, "w") as f:
        f.create_dataset("images", data=rng.integers(
            0, 255, (137, 8, 8, 3), dtype=np.uint8), chunks=(10, 8, 8, 3))
        f.create_dataset("labels", data=rng.integers(
            0, 2, (137, 1), dtype=np.uint8), chunks=(10, 1))
    return path


@pytest.mark.parametrize("argv", [["shuffle", "--block", "13"],
                                  ["shuffle", "--mem", "--seed", "4"],
                                  ["reshape", "--chunk", "64", "--block", "50"],
                                  ["reshape", "--mem"]])
def test_hdf5_tools_match_gpd_tpu(dataset, tmp_path, argv, capsys):
    """shuffle and reshape write the same datasets, chunks and output lines
    as gpd_tpu's."""
    cmd, opts = argv[0], argv[1:]
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    assert hdf5_tools.main([cmd, dataset, ours] + opts) == 0
    out_ours = capsys.readouterr().out.replace(ours, "DST")
    assert jtools.main([cmd, dataset, theirs] + opts) == 0
    assert out_ours == capsys.readouterr().out.replace(theirs, "DST")
    with h5py.File(ours) as a, h5py.File(theirs) as b:
        assert set(a) == set(b) == {"images", "labels"}
        for name in a:
            assert a[name].chunks == b[name].chunks
            np.testing.assert_array_equal(a[name][:], b[name][:])


def test_hdf5_tools_info_and_gated_converters(dataset, tmp_path, capsys):
    assert hdf5_tools.main(["info", dataset]) == 0
    ours = capsys.readouterr().out
    assert jtools.main(["info", dataset]) == 0
    assert ours == capsys.readouterr().out and "positives" in ours
    for sub, dst in (("to-zarr", "z.zarr"), ("to-lmdb", "l.lmdb")):
        try:
            __import__(sub.split("-")[1])
        except ImportError:
            assert hdf5_tools.main([sub, dataset, str(tmp_path / dst)]) == 2
            assert jtools.main([sub, dataset, str(tmp_path / dst)]) == 2
