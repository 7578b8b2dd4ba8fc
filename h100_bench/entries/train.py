"""Entry ``train``: ``tools/train_classifier.py``'s job, ``net.train.fit``
at batch 256 over an in-memory dataset read in blocks (``HDF5Dataset``'s
``max_in_memory``), with an evaluation of the test set after each block.

The data (``inputs.generate.train_data``) is drawn from the seed in
set-up. One ``fit`` call is the object set-up builds and the window
measures: its first epoch is set-up (the step graph's capture at step 1,
the evaluation graph's at the first evaluation), then the window runs
whole epochs until ``seconds`` have passed; the dataset ends the call. The rate counts the images of the steps completed
in the window, over the window.

Correct: three steps from each of three states of that call, against the
plain reference's LeNet and Adam (``reference/train.py``) on the same rows:
from the initial parameters (set-up's first steps), from the state at the
window's first step, and from the state at the first step of the window's
second block (after the block's upload). Each start is the program's own
state, copied as its step ends; the reference follows it with the rows
the program's shuffle draws. Compared: each step's loss, each leaf's
change after the three steps and, from the initial state, each leaf's
first gradient as Adam took it (from its first moment after step 1). The
initial state is held apart against the stated initialisation
(``init_gap``, logged).
"""

from __future__ import annotations

import contextlib
import gc
import io
import time
import warnings
from typing import List

import numpy as np

from h100_bench import harness
from h100_bench import trace as tr


def _optimizers() -> list:
    """The optimizers alive in the process."""
    import torch
    with warnings.catch_warnings():
        # isinstance over every object touches deprecated torch aliases.
        warnings.simplefilter("ignore", FutureWarning)
        return [o for o in gc.get_objects()
                if isinstance(o, torch.optim.Optimizer)]


def _optimizer(before: list):
    """``fit``'s optimizer: the one alive now that was not ``before``."""
    found = [o for o in _optimizers() if not any(o is b for b in before)]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} new optimizers; fit's one sought")
    return found[0]


def _state(opt, step: int):
    """The optimizer's parameters and Adam moments after ``step`` steps,
    copied on the device (``reference.train.State``)."""
    import torch
    from h100_bench.reference.train import State
    params = [p for g in opt.param_groups for p in g["params"]]
    st = State([p.detach().clone() for p in params], t=step)
    if step:
        # A leaf the optimizer never stepped holds no moments: zeros.
        st.m, st.v = ([opt.state.get(p, {}).get(k, torch.zeros_like(p))
                       .detach().clone() for p in params]
                      for k in ("exp_avg", "exp_avg_sq"))
    return st


class WindowClosed(Exception):
    """Raised by the training set's ``blocks()`` once the window has
    closed: it ends the ``fit`` call (whose return is not needed)."""


class Blocks:
    """A dataset for ``fit``: ``blocks()`` yields (images, labels) blocks of
    ``block`` rows, and, for the training set, decides when the window
    opens (the second epoch's start) and closes (the first epoch's start
    after ``seconds``: whole epochs, so every seed does the same work),
    tracing one epoch when asked."""

    def __init__(self, images, labels, block, clock=None):
        self.images, self.labels, self.block = images, labels, block
        self.clock = clock

    def blocks(self):
        c = self.clock
        if c is not None and not c.epoch_start():
            raise WindowClosed
        for a in range(0, len(self.labels), self.block):
            if c is not None and a:
                c.block_start()
            yield (self.images[a:a + self.block],
                   self.labels[a:a + self.block])


class Clock:
    """The window of a ``fit`` call, kept by its dataset and ``on_step``."""

    def __init__(self, r: harness.Run, block_steps):
        import torch
        self.r, self.torch = r, torch
        self.epoch = 0
        self.t0 = self.t1 = None
        self.step = 0
        self.steps_at_open = 0
        self.steps_at_close = 0
        self.first = {}
        self.prof = None
        self.span = None
        self.block_steps = block_steps
        self.block_i = 0
        self.in_block = 0
        # The checked starts: the initial state, the window's first step
        # and the first step of the window's second block.
        epoch = sum(block_steps)
        self.starts = [0, epoch] + ([epoch + block_steps[0]]
                                    if len(block_steps) > 1 else [])
        self.got = {s: {} for s in self.starts}
        self.opt = None
        self.before = _optimizers()

    def _open_span(self):
        if self.prof is not None:
            self.span = tr.span("bench_train_steps")
            self.span.__enter__()

    def _close_span(self):
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None

    def epoch_start(self) -> bool:
        """Called as each epoch asks for its blocks; False ends ``fit``."""
        now = time.perf_counter()
        self.epoch += 1
        if self.epoch == 1:
            # fit has built its net and optimizer: the initial state.
            self.opt = _optimizer(self.before)
            self.before = None
            self.got[0]["state"] = _state(self.opt, 0)
        if self.epoch == 2:
            self.r.sync()
            self.t0 = time.perf_counter()
            self.steps_at_open = self.step
            if self.r.trace:
                self.prof = tr.profiler()
                self.prof.__enter__()
                self.window = tr.span(tr.WINDOW)
                self.window.__enter__()
        elif self.epoch > 2 and self.t1 is None and (
                self.r.trace or now - self.t0 >= self.r.seconds):
            self._close()
            return False
        self.block_i = 0
        self._open_span()
        return self.t1 is None

    def block_start(self) -> None:
        """Called before each later block of an epoch."""
        self.block_i += 1
        self._open_span()

    def _close(self):
        self.r.sync()
        self.t1 = time.perf_counter()
        self.steps_at_close = self.step
        if self.prof is not None:
            self.window.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)

    def on_step(self, step, loss, acc):
        self.step = step
        for s0 in self.starts:
            got, k = self.got[s0], step - s0
            if k == 0:
                got["state"] = _state(self.opt, step)
            elif 1 <= k <= 3:
                # Copies on the device, before the next step.
                got[f"loss{k}"] = loss.detach().clone()
                if k == 1 and s0 == 0:
                    # The first gradient as Adam took it: its first moment
                    # after one step over (1 - beta1).
                    beta1 = self.opt.param_groups[0]["betas"][0]
                    params = [p for g in self.opt.param_groups
                              for p in g["params"]]
                    got["grad1"] = [
                        self.opt.state[p]["exp_avg"].detach().clone()
                        / (1 - beta1) if "exp_avg" in self.opt.state.get(p, {})
                        else self.torch.zeros_like(p) for p in params]
                if k == 3:
                    got["params3"] = [p.detach().clone() for g in
                                      self.opt.param_groups
                                      for p in g["params"]]
        self.in_block += 1
        if self.in_block == self.block_steps[self.block_i % len(
                self.block_steps)]:
            self.in_block = 0
            self._close_span()


def batches_of(seed: int, sizes: List[int], batch: int, starts,
               epochs: int = 2) -> dict:
    """The rows of the three steps after each start, as ``fit`` draws
    them: one permutation per block in order, every epoch, from
    ``default_rng(seed)``, full batches only. Returns {start: [rows (into
    the whole training set) of each step]}."""
    rng = np.random.default_rng(seed)
    rows, at = [], 0
    for _ in range(epochs):
        at = 0
        for n in sizes:
            perm = rng.permutation(n) + at
            rows += [perm[i:i + batch] for i in range(0, n - batch + 1,
                                                       batch)]
            at += n
    return {s0: rows[s0:s0 + 3] for s0 in starts}


def reference_pass(r: harness.Run, clock: Clock, xtr, ytr, sizes, seed):
    """The numbers from each start (and each control's in the program's
    place): (numbers, {control: numbers})."""
    import torch
    from h100_bench.reference import train as ref
    mix = r.traffic
    rows = batches_of(seed, sizes, mix["batch"], clock.starts)
    need = np.unique(np.concatenate([np.concatenate(b)
                                     for b in rows.values()]))
    where = {int(j): i for i, j in enumerate(need)}
    x = torch.from_numpy(np.ascontiguousarray(xtr[need])).to(r.device)
    y = torch.from_numpy(ytr[need].astype(np.int64)).to(r.device)
    local = {s0: [np.array([where[int(j)] for j in b]) for b in bs]
             for s0, bs in rows.items()}
    nums = {"init_gap": ref.init_gap(clock.got[0]["state"].params)}
    ctrl = {c: {} for c in r.controls}
    for s0 in clock.starts:
        got, st = clock.got[s0], clock.got[s0]["state"]
        base = ref.steps(st, x, y, local[s0], mix)
        pre = "" if s0 == 0 else "window_"
        for k, v in ref.compare(got, base).items():
            nums[pre + k] = max(nums.get(pre + k, 0.0), v)
        for c in r.controls:
            half = [b[:len(b) // 2] for b in local[s0]]
            alt = ref.steps(st, x, y, half if c == "half_batch"
                            else local[s0], mix, tf32_on=c == "geometry")
            for k, v in ref.compare(alt, base).items():
                ctrl[c][pre + k] = max(ctrl[c].get(pre + k, 0.0), v)
    return [nums], {c: [v] for c, v in ctrl.items()}


def run(r: harness.Run) -> harness.Outcome:
    import torch
    from gpd_tpu_torch.net import train
    from h100_bench.inputs import generate
    mix = r.traffic
    xtr, ytr, xte, yte = generate.train_data(mix, r.seed, r.device)
    batch, block = mix["batch"], mix["block"]
    sizes = [min(block, len(ytr) - a) for a in range(0, len(ytr), block)]
    clock = Clock(r, [s // batch for s in sizes])
    ds = Blocks(xtr, ytr, block, clock)
    test = Blocks(xte, yte, block)
    seed = r.seed % (1 << 32)
    r.log(f"# set-up: {len(ytr)} training and {len(yte)} test images drawn "
          f"at {time.perf_counter() - r.t_start:.3f} s")
    cuda = r.device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            train.fit(ds, test, num_channels=mix["channels"],
                      epochs=1 << 30, batch_size=batch, lr=mix["lr"],
                      weight_decay=mix["weight_decay"], seed=seed,
                      device=r.device, on_step=clock.on_step)
    except WindowClosed:
        pass
    steps = clock.steps_at_close - clock.steps_at_open
    window_s = clock.t1 - clock.t0
    setup_s = clock.t0 - r.t_start
    r.log(f"# window {window_s:.3f} s: {steps} steps of {batch} in "
          f"{clock.epoch - 2} epochs; fit printed "
          f"{len(log.getvalue().splitlines())} lines")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else None
    e2e = {"setup_s": setup_s, "train_images_per_s": steps * batch / window_s}
    layer, busy, window, bd = {}, None, None, None
    if r.trace:
        evs = tr.events(clock.prof, r.tmp)
        s = tr.summary(evs)
        busy, window, bd = s["busy_s"], s["window_s"], s["breakdown"]
        layer = dict(events=evs, window=s["window"], steps=steps,
                     steps_spanned=steps, images=steps * batch,
                     channels=mix["channels"], size=mix["size"])
    t0 = time.perf_counter()
    nums, ctrl = reference_pass(r, clock, xtr, ytr, sizes, seed)
    r.log(f"# reference over {len(clock.starts)} x 3 steps in "
          f"{time.perf_counter() - t0:.3f} s: "
          + ", ".join(f"{a} {b!r}" for a, b in nums[0].items()))
    checks = [harness.Check(k, nums[0][k], v)
              for k, v in r.workload["limits"].items()]
    return harness.Outcome(setup_s=setup_s, attempted=steps, failed=0,
                           end_to_end=e2e, checks=checks,
                           memory_peak_bytes=peak, layer=layer, busy_s=busy,
                           window_s=window, breakdown=bd, numbers=nums,
                           control=ctrl)
