"""The port's classifier-pipeline tools (gpd_tpu_torch/tools/: gen_dataset,
train_classifier, slice_channels) and its packaged checkpoints, against
gpd_tpu's tools (tools/*.py, imported by path) on the CPU.

  - ``build_items`` of both packages, driven by a stub detector that logs
    what ``preprocess_cloud`` is given, yield the same work list item for
    item (the NumPy rendering is shared, so equality is exact).
  - The port's ``gen_dataset.main`` writes the reference's HDF5 layout,
    routes the last view to test.h5 and resumes from its journal.
  - ``train_classifier.main`` writes float16 under gpd_tpu's key names:
    gpd_tpu's ``load_params_npz`` + ``forward`` give the port's logits.
  - ``slice_channels`` writes gpd_tpu's tool's datasets byte for byte.
  - ``lenet.default_params_path`` is the port's own copy, byte for byte
    gpd_tpu's, and no module of the port names a path under gpd_tpu/.
"""

import ast
import hashlib
import importlib.util
import os
import sys
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from gpd_tpu.net import lenet as jlenet  # noqa: E402
from gpd_tpu_torch.net import lenet  # noqa: E402
from gpd_tpu_torch.tools import (gen_dataset, slice_channels,  # noqa: E402
                                 train_classifier)
from test_torch_threads import set_cpu_share  # noqa: E402

set_cpu_share()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gpd_tool(name):
    """gpd_tpu's tools/<name>.py as a module (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"gpd_tpu_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class RecordingDetector:
    """Logs each ``preprocess_cloud`` call's arguments as host arrays and
    returns the call's index in place of a cloud."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def preprocess_cloud(self, points, view_points=None, cam_source=None,
                         capacity=None):
        self.calls.append((np.array(points), np.array(view_points),
                           None if cam_source is None
                           else np.array(cam_source), capacity))
        return len(self.calls) - 1


def test_build_items_match_gpd_tpu():
    """2 objects x 2 views and 1 scene x 2 views: the same (name, view,
    raw points, view points, camera sources, capacity) sequence, and the
    same mesh points and normals at the same capacities."""
    jtool = gpd_tool("gen_dataset")
    ours, theirs = RecordingDetector(), RecordingDetector()
    ti = list(gen_dataset.build_items(ours, 2, 2, num_scenes=1))
    ji = list(jtool.build_items(theirs, 2, 2, num_scenes=1))
    assert [(n, v) for n, v, _, _ in ti] == [(n, v) for n, v, _, _ in ji]
    assert [n for n, _, _, _ in ti] == ["scene_000"] * 2 + ["box_000"] * 2 \
        + ["cylinder_001"] * 2
    assert len(ours.calls) == len(theirs.calls) == 6
    for (tp, tv, tc, tcap), (jp, jv, jc, jcap) in zip(ours.calls,
                                                      theirs.calls):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tv, jv)
        assert (tc is None) == (jc is None)
        if tc is not None:
            np.testing.assert_array_equal(tc, jc)
        assert tcap == jcap
    assert [c[3] for c in ours.calls] == [gen_dataset.SCENE_VIEW_CAPACITY] \
        * 2 + [gen_dataset.VIEW_CAPACITY] * 4
    for (_, _, tview, tmesh), (_, _, jview, jmesh) in zip(ti, ji):
        assert tview == jview
        assert tmesh.capacity == jmesh.capacity
        np.testing.assert_array_equal(tmesh.points.numpy(),
                                      np.asarray(jmesh.points))
        np.testing.assert_array_equal(tmesh.normals.numpy(),
                                      np.asarray(jmesh.normals))
        np.testing.assert_array_equal(tmesh.mask.numpy(),
                                      np.asarray(jmesh.mask))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The port's gen_dataset.main on the CPU: 1 object x 2 views, no
    scenes, 32 samples a view; then a rerun of the same command."""
    out = str(tmp_path_factory.mktemp("dataset"))
    with mock.patch.object(gen_dataset, "NUM_SAMPLES", 32):
        assert gen_dataset.main([out, "1", "2", "0"], device="cpu") == 0
        first = read_set(out)
        assert gen_dataset.main([out, "1", "2", "0"], device="cpu") == 0
    return out, first


def read_set(out):
    sets = {}
    for split in ("train", "test"):
        with h5py.File(os.path.join(out, f"{split}.h5"), "r") as f:
            sets[split] = {k: (f[k][:], f[k].dtype, f[k].shape[1:])
                           for k in ("images", "labels")}
        with open(os.path.join(out, f"{split}.h5.journal")) as f:
            sets[split]["journal"] = f.read()
    return sets


def test_gen_dataset_writes_the_reference_layout(dataset):
    """train.h5 and test.h5 in the reference's layout, balanced, view 0 in
    train and the held-out view 1 in test; the rerun adds nothing."""
    out, first = dataset
    for split, view in (("train", 0), ("test", 1)):
        (images, idt, ishape), (labels, ldt, lshape) = (
            first[split]["images"], first[split]["labels"])
        assert idt == ldt == np.uint8
        assert ishape == (60, 60, 15) and lshape == (1,)
        assert len(images) == len(labels) > 0
        assert 2 * int(labels.sum()) == len(labels)
        assert images.any()
        assert f'"obj": "box_000", "view": {view}' in first[split]["journal"]
    again = read_set(out)
    for split in ("train", "test"):
        assert again[split]["journal"] == first[split]["journal"]
        for k in ("images", "labels"):
            a, b = first[split][k][0], again[split][k][0]
            assert a.shape == b.shape
            np.testing.assert_array_equal(
                np.sort(a.reshape(len(a), -1), axis=0),
                np.sort(b.reshape(len(b), -1), axis=0))


def test_train_classifier_checkpoint_loads_in_gpd_tpu(dataset, tmp_path):
    """One epoch (at batch 32, so the set takes steps) writes float16 under
    gpd_tpu's keys; gpd_tpu's loader and forward give the port's logits on
    the same images within 1e-4."""
    out, first = dataset
    ckpt = str(tmp_path / "lenet_15ch")
    with mock.patch.object(train_classifier, "BATCH_SIZE", 32):
        assert train_classifier.main([out, "1", ckpt], device="cpu") == 0
    with np.load(ckpt + ".npz") as f:
        stored = {k: f[k] for k in f.files}
    packaged = np.load(lenet.default_params_path(15))
    assert sorted(stored) == sorted(packaged.files)
    assert all(v.dtype == np.float16 for v in stored.values())
    init = lenet.init_params(torch.Generator().manual_seed(0), 15)
    assert any(not np.array_equal(stored[k], init[k].astype(np.float16))
               for k in stored)
    images = first["test"]["images"][0][:16]
    theirs = np.asarray(jlenet.forward(
        jlenet.load_params_npz(ckpt + ".npz"), jnp.asarray(images)))
    net = lenet.params_from_numpy(lenet.load_params(ckpt + ".npz", 15),
                                  device="cpu")
    ours = net(torch.from_numpy(images)).detach().numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-4)


@pytest.mark.parametrize("content,epochs", [("2", 2), ("9", 4), (" 1\n", 1),
                                            ("0", None), ("two", None),
                                            ("-3", None), ("", None)])
def test_epochs_override_file(tmp_path, monkeypatch, content, epochs):
    """GPD_EPOCHS_OVERRIDE_FILE clamps the epochs to a positive integer;
    any other content fails loudly; a missing file changes nothing."""
    path = tmp_path / "epochs"
    monkeypatch.setenv("GPD_EPOCHS_OVERRIDE_FILE", str(path))
    assert train_classifier.clamp_epochs(4) == 4
    path.write_text(content)
    if epochs is None:
        with pytest.raises(SystemExit, match="positive int"):
            train_classifier.clamp_epochs(4)
    else:
        assert train_classifier.clamp_epochs(4) == epochs


@pytest.mark.parametrize("channels", [[], ["0", "3"], ["5", "8"]])
def test_slice_channels_matches_gpd_tpu(tmp_path, monkeypatch, channels):
    """Both tools on one 15-channel set: the same datasets, byte for byte,
    with the same dtypes and chunking."""
    rng = np.random.default_rng(5)
    src = str(tmp_path / "in.h5")
    with h5py.File(src, "w") as f:
        f.create_dataset("images", data=rng.integers(
            0, 256, (1100, 8, 8, 15), dtype=np.uint8))
        f.create_dataset("labels", data=rng.integers(
            0, 2, (1100, 1), dtype=np.uint8))
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    assert slice_channels.main([src, ours] + channels) == 0
    monkeypatch.setattr(sys, "argv", ["slice_channels.py", src, theirs]
                        + channels)
    gpd_tool("slice_channels").main()
    c0, c1 = (int(c) for c in channels) if channels else (0, 3)
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b, \
            h5py.File(src, "r") as s:
        assert set(a) == set(b) == {"images", "labels"}
        for k in ("images", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].chunks == b[k].chunks
            assert a[k][:].tobytes() == b[k][:].tobytes()
        np.testing.assert_array_equal(a["images"][:],
                                      s["images"][:, :, :, c0:c1])


@pytest.mark.parametrize("channels", [15, 3])
def test_default_params_path_is_the_ports_own_copy(channels):
    path = lenet.default_params_path(channels)
    pkg = os.path.join(REPO, "gpd_tpu_torch")
    assert os.path.commonpath([os.path.realpath(path), pkg]) == pkg

    def sha(p):
        with open(p, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    assert sha(path) == sha(jlenet.default_params_path(channels))


def named_gpd_tpu_paths(source):
    """String literals of Python source, docstrings apart, that name a
    path under gpd_tpu/: a "gpd_tpu" component of a path join, or a
    "gpd_tpu/..." string other than a file:line citation."""
    tree = ast.parse(source)
    docstrings = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(
                body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
            docstrings.add(id(body[0].value))
    found = []
    for node in ast.walk(tree):
        func = getattr(node, "func", None)
        if getattr(func, "attr", getattr(func, "id", None)) in ("join",
                                                                "Path"):
            found += [a.value for a in node.args
                      if isinstance(a, ast.Constant) and a.value == "gpd_tpu"]
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docstrings):
            for part in node.value.split("gpd_tpu" + "/")[1:]:
                head = (part.split() or [""])[0]
                if not (".py:" in head and head.split(".py:")[1][:1]
                        .isdigit()):
                    found.append(node.value)
    return found


def test_the_path_check_finds_paths():
    """The check below flags the joins and strings that read a gpd_tpu
    file, and passes comments, docstrings and file:line citations."""
    flagged = named_gpd_tpu_paths(
        'def f(d, c):\n'
        '    """Reads gpd_tpu/models/x.npz."""\n'
        '    # gpd_tpu/models/x.npz\n'
        '    a = os.path.join(d, "..", "..", "gpd_tpu", "models", c)\n'
        '    b = open(d + "/../gpd_tpu/models/lenet_15ch.npz")\n'
        '    c = _str_field(2, "gpd_tpu")\n'
        '    return dict(replaces="gpd_tpu/ops/images.py:204", n="gpd_tpu")\n')
    assert flagged == ["gpd_tpu", "/../gpd_tpu/models/lenet_15ch.npz"]


def test_no_port_file_names_a_gpd_tpu_path():
    """The port and chip_smoke.py read nothing under gpd_tpu/: no string
    outside comments and docstrings names such a path (a "file:line"
    citation of gpd_tpu's source, as a kernel's ``replaces``, is not a
    path the program opens)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gpd_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = {}
    for path in files:
        with open(path) as f:
            found = named_gpd_tpu_paths(f.read())
        if found:
            bad[path] = found
    assert not bad
