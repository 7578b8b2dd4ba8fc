"""The training and evaluation steps as gpd_tpu's jitted programs
(gpd_tpu_torch/net/train.py ``StepGraphs``; gpd_tpu/net/train.py:48-65): on
the CPU the same step body against gpd_tpu's ``train_step``, and on the card
the CUDA graph route against the eager step.

A LeNet at batch 8. The CPU test imports gpd_tpu inside its body; the tests
marked ``cuda`` need a card and skip without one, and the module imports no
JAX, so they run where there is none:

    python -m pytest tests/test_torch_train_graph.py -m cuda --noconftest
"""

import gc
import unittest.mock as mock
import weakref

import numpy as np
import pytest
import torch

from gpd_tpu_torch import graphs as layer
from gpd_tpu_torch.net import lenet, train
from test_torch_threads import set_cpu_share

set_cpu_share()

LR = 1e-3


def batches(n, channels, seed, batch=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (batch, 60, 60, channels)).astype(np.uint8),
             rng.integers(0, 2, batch).astype(np.int32)) for _ in range(n)]


def test_three_steps_match_gpd_tpu():
    """Three steps of StepGraphs.train_step (on the CPU its eager body, as
    fit takes it) against gpd_tpu's jitted train_step from the same
    parameters and batches: each step's loss within 1e-5 (relative above
    1) and accuracy equal; after the three, parameters within 1e-6 but for
    fewer than one entry in 10^4, none more than 2 lr a step apart (Adam's
    first update is lr * g / (|g| + eps), so a gradient at rounding level
    flips the sign of its update; tests/test_torch_train.py)."""
    import jax
    import jax.numpy as jnp
    from gpd_tpu.net import lenet as jlenet
    from gpd_tpu.net import train as jtrain
    params = {k: np.asarray(v) for k, v in jlenet.init_params(
        jax.random.PRNGKey(0), 3).items()}
    tx = jtrain.make_optimizer(LR, 5e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    net = lenet.params_from_numpy(params, device="cpu")
    opt = train.make_optimizer(net, LR, 5e-4)
    steps = train.StepGraphs("cpu")
    for x, y in batches(3, 3, 1):
        jp, state, jl, ja = jtrain.train_step(jp, state, jnp.asarray(x),
                                              jnp.asarray(y), tx)
        tl, ta = steps.train_step(net, opt, torch.from_numpy(x),
                                  torch.from_numpy(y).long())
        assert abs(float(tl) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
        assert float(ta) == float(ja)
    assert steps.graphs == {}
    ours = lenet.params_to_numpy(net)
    gaps = np.concatenate([np.abs(ours[k] - np.asarray(jp[k])).ravel()
                           for k in params])
    assert (gaps > 1e-6).mean() < 1e-4
    assert gaps.max() <= 2 * LR * 3


# ------------------------------------------------------------- on the card

def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the steps are captured as CUDA "
                    "graphs only there (chip_smoke.py runs them)")


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's default weight-gradient algorithms add in no fixed order, so
    two plain runs differ at rounding level: routes are compared under
    deterministic cuDNN."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def card_net(seed=0, channels=15):
    return lenet.params_from_numpy(lenet.init_params(
        torch.Generator().manual_seed(seed), channels), "cuda")


def on_card(data):
    return [(torch.from_numpy(x).cuda(), torch.from_numpy(y).long().cuda())
            for x, y in data]


@pytest.mark.cuda
def test_graph_steps_equal_eager_steps(deterministic_cudnn):
    """Six steps by StepGraphs (the capture's warm-up is the first, five
    replays) and six eager train_steps from the same parameters and
    batches: equal losses and accuracies, parameters and Adam's moments
    within 1e-6 of each tensor's largest entry; one graph."""
    needs_card()
    data = on_card(batches(6, 15, 2))
    runs = []
    for graphs in (train.StepGraphs("cuda"), None):
        net = card_net()
        opt = train.make_optimizer(net)
        step = train.train_step if graphs is None else graphs.train_step
        out = [step(net, opt, x, y) for x, y in data]
        runs.append(([(float(l), float(a)) for l, a in out],
                     lenet.params_to_numpy(net),
                     [s["exp_avg_sq"].cpu().numpy()
                      for s in opt.state.values()]))
        if graphs is not None:
            assert len(graphs.graphs) == 1
    (lg, pg, vg), (le, pe, ve) = runs
    np.testing.assert_allclose(lg, le, rtol=0, atol=1e-6)
    for k in pe:
        assert np.abs(pg[k] - pe[k]).max() <= 1e-6 * np.abs(pe[k]).max(), k
    for a, b in zip(vg, ve):
        assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.cuda
def test_one_capture_per_key_and_outputs_are_copies():
    """A train graph per batch shape, an eval graph per padded batch
    shape; replays capture nothing; a step's loss outlives the next
    replay."""
    needs_card()
    net = card_net()
    opt = train.make_optimizer(net)
    graphs = train.StepGraphs("cuda")
    (x8, y8), = on_card(batches(1, 15, 3))
    (x4, y4), = on_card(batches(1, 15, 4, batch=4))
    first, _ = graphs.train_step(net, opt, x8, y8)
    kept = float(first)
    for _ in range(3):
        graphs.train_step(net, opt, x8, y8)
        graphs.train_step(net, opt, x4, y4)
    assert float(first) == kept
    w = torch.ones(8, device="cuda")
    for _ in range(2):
        graphs.eval_step(net, x8, y8, w)
    assert sorted(k[0] for k in graphs.graphs) == ["eval", "train", "train"]


class Blocks:
    def __init__(self, data):
        self.images = np.concatenate([x for x, _ in data])
        self.labels = np.concatenate([y for _, y in data])

    def blocks(self):
        yield self.images, self.labels


@pytest.mark.cuda
def test_fit_replays_its_steps(deterministic_cudnn):
    """fit on the card (no process group) against eager steps on its own
    batches (its init and permutation): each on_step loss equal, the same
    parameters, evaluate's numbers equal eager eval_step sums; fit captures
    one train graph and one eval graph."""
    needs_card()
    data, held = batches(10, 15, 5), Blocks(batches(3, 15, 6, batch=5))
    ds = Blocks(data)
    losses = []
    with mock.patch.object(layer, "CapturedGraph",
                           wraps=layer.CapturedGraph) as capture:
        params = train.fit(ds, held, 15, epochs=1, batch_size=16, seed=0,
                           device="cuda", data_parallel=False,
                           on_step=lambda s, l, a: losses.append(l))
    assert capture.call_count == 2
    net = card_net()
    opt = train.make_optimizer(net)
    perm = np.random.default_rng(0).permutation(len(ds.labels))
    x, y = on_card([(ds.images, ds.labels)])[0]
    eager = [train.train_step(net, opt, x[sel], y[sel])[0]
             for sel in torch.from_numpy(perm).cuda().split(16)]
    assert len(losses) == len(eager) == 5
    np.testing.assert_allclose([float(l) for l in losses],
                               [float(l) for l in eager], rtol=0, atol=1e-6)
    ours = lenet.params_to_numpy(net)
    for k in ours:
        assert np.abs(params[k] - ours[k]).max() <= \
            1e-6 * np.abs(ours[k]).max(), k
    loss, acc = train.evaluate(lenet.params_from_numpy(params, "cuda"), held)
    hx, hy = on_card([(held.images, held.labels)])[0]
    s, c = train.eval_step(lenet.params_from_numpy(params, "cuda"), hx, hy,
                           torch.ones(len(hy), device="cuda"))
    assert abs(loss - float(s) / len(hy)) <= 1e-5 * max(1.0, loss)
    assert acc == int(c) / len(hy)


def test_evaluate_keeps_its_step_graphs_with_the_net():
    """evaluate without ``steps=`` makes one StepGraphs per net, kept with
    the net (not a submodule, not in its state dict), and reuses it on
    later calls; another net gets its own."""
    held = Blocks(batches(2, 15, 6, batch=5))
    net = lenet.params_from_numpy(lenet.init_params(
        torch.Generator().manual_seed(0), 15), "cpu")
    with mock.patch.object(train, "StepGraphs",
                           wraps=train.StepGraphs) as made:
        first = train.evaluate(net, held)
        assert train.evaluate(net, held) == first
        assert made.call_count == 1
        steps = train.net_steps(net)
        assert train.net_steps(net) is steps and made.call_count == 1
        other = lenet.params_from_numpy(lenet.params_to_numpy(net), "cpu")
        assert train.evaluate(other, held) == first
        assert made.call_count == 2 and train.net_steps(other) is not steps
    assert "_step_graphs" not in dict(net.named_children())
    assert set(net.state_dict()) == set(other.state_dict())


@pytest.mark.cuda
def test_evaluate_captures_once_per_net():
    """Two evaluate calls on one card net capture one eval graph."""
    needs_card()
    held = Blocks(batches(3, 15, 6, batch=5))
    net = card_net()
    with mock.patch.object(layer, "CapturedGraph",
                           wraps=layer.CapturedGraph) as capture:
        first = train.evaluate(net, held)
        np.testing.assert_allclose(train.evaluate(net, held), first,
                                   atol=1e-6)
    assert capture.call_count == 1


@pytest.mark.cuda
def test_evaluated_net_is_freed_without_the_cyclic_gc():
    """The eval graphs kept with a net reach it through a weak reference:
    dropping the last reference to an evaluated net frees it, its graphs
    with it, without the cyclic garbage collector."""
    needs_card()
    held = Blocks(batches(2, 15, 6, batch=5))
    net = card_net()
    train.evaluate(net, held)
    assert train.net_steps(net).graphs
    gone = weakref.ref(net)
    gc.disable()
    try:
        del net
        assert gone() is None
    finally:
        gc.enable()


@pytest.mark.cuda
def test_shared_step_graphs_recapture_for_a_freed_nets_identity():
    """A StepGraphs shared by nets: once an evaluated net is freed, a later
    net evaluates as a fresh StepGraphs does, whether or not it took the
    freed net's identity."""
    needs_card()
    held = Blocks(batches(2, 15, 6, batch=5))
    steps = train.StepGraphs("cuda")
    train.evaluate(card_net(0), held, steps=steps)
    gc.collect()
    net = card_net(1)
    want = train.evaluate(net, held, steps=train.StepGraphs("cuda"))
    np.testing.assert_allclose(train.evaluate(net, held, steps=steps), want,
                               atol=1e-6)
