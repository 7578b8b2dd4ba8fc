"""A run whose timed path is broken underneath comes out not correct: the
rest of the run as the harness drives it (at tiny sizes on the CPU, the
card's look skipped), with each fault a cell can have planted in the
program where it produces its answer or its step."""

import json

import pytest

from h100_bench import harness


def run(cell, tmp_path):
    line, _ = harness.cpu_pass(cell, 2 ** 31 + 3, False, str(tmp_path))
    return json.loads(line)


def altered_hands(monkeypatch):
    """The selection's grasps moved to another sample's hand."""
    from gpd_tpu_torch import detector
    real = detector.select_and_cluster

    def wrong(grasps, cfg):
        out = real(grasps, cfg)
        out.sample_id = (out.sample_id + 1) % cfg.num_samples
        return out
    monkeypatch.setattr(detector, "select_and_cluster", wrong)


def reversed_scores(monkeypatch):
    """The classifier's scores negated: the worst hands are selected."""
    from gpd_tpu_torch.net import lenet
    real = lenet.score
    monkeypatch.setattr(lenet, "score", lambda *a, **k: -real(*a, **k))


def flipped_images(monkeypatch):
    """The grasp images upside down where they are made: every valid
    hand scores another image."""
    from gpd_tpu_torch.ops import images
    real = images.make_images
    monkeypatch.setattr(images, "make_images",
                        lambda *a, **k: real(*a, **k).flip(1))


def narrowed_hands(monkeypatch):
    """The hand search's widths a tenth narrower where they are made."""
    import dataclasses
    from gpd_tpu_torch.ops import candidates
    real = candidates.search_hands_with_frames

    def wrong(*a, **k):
        g = real(*a, **k)
        return dataclasses.replace(g, width=g.width * 0.9)
    monkeypatch.setattr(candidates, "search_hands_with_frames", wrong)


def stale_rows(monkeypatch):
    """From the window on, every step takes the rows of the first step
    again (a block left stale on the device)."""
    from gpd_tpu_torch.net import train
    real = train.train_step
    seen = []

    def step(net, opt, x, y):
        seen.append((x.clone(), y.clone()))
        if len(seen) > 24:            # the tiny epoch's 16 + 8 steps
            x, y = seen[0]
        return real(net, opt, x, y)
    monkeypatch.setattr(train, "train_step", step)


def unchanged_state(monkeypatch):
    """A step that computes its loss and leaves the state unchanged."""
    from gpd_tpu_torch.net import train

    def step(net, opt, x, y):
        opt.zero_grad(set_to_none=True)
        loss, logits = train.loss_fn(net, x, y)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss.detach(), acc
    monkeypatch.setattr(train, "train_step", step)


def half_batch(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from gpd_tpu_torch.net import train
    real = train.train_step

    def step(net, opt, x, y):
        return real(net, opt, x[:len(x) // 2], y[:len(y) // 2])
    monkeypatch.setattr(train, "train_step", step)


@pytest.mark.parametrize("cell,fault", [
    ("gpd15.table_stream", altered_hands),
    ("gpd15.table_stream", reversed_scores),
    ("gpd15.table_stream", flipped_images),
    ("gpd15.table_stream", narrowed_hands),
    ("gpd3.pcd_stream", altered_hands),
    ("gpd3.pcd_stream", reversed_scores),
    ("gpd3.pcd_stream", flipped_images),
    ("gpd3.pcd_stream", narrowed_hands),
    ("gpd15.train_epochs", unchanged_state),
    ("gpd15.train_epochs", half_batch),
    ("gpd15.train_epochs", stale_rows),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    res = run(cell, tmp_path)
    assert res["correct"] is False, res["checks"]
