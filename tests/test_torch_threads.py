"""One CPU share per pytest-xdist worker for torch in the port's tests.

torch starts one intra-op thread per CPU in every process. Under
``pytest -n N`` the N workers would then run up to N times as many threads
as there are CPUs, and the port's CPU-heavy cases (two routes of a detector
compared at a few hundred samples) slow down several times over. Every
``tests/test_torch_*.py`` calls ``set_cpu_share()`` at import, so a worker
runs torch on ``cpus // N`` threads. Outside xdist nothing changes and a
single process keeps every CPU.

The share goes to the processes the port's tests start through the
``env`` that ``share_env`` builds. The worker's own ``os.environ`` is never
written, so the gpd_tpu tests that share a worker keep their environment;
JAX's thread pool is left as it is.

The module imports no JAX: the card-only test files import it too.
"""

import os

import torch


def cpu_share():
    """Threads for one xdist worker: the CPUs this process may run on over
    the number of workers, at least 1; None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


def set_cpu_share():
    """Run torch on one CPU share inside an xdist worker; outside xdist
    leave torch's default."""
    share = cpu_share()
    if share is not None:
        torch.set_num_threads(share)


def share_env(env=None):
    """A copy of ``env`` (default ``os.environ``) for a subprocess, with
    ``OMP_NUM_THREADS`` set to the share inside an xdist worker."""
    out = dict(os.environ if env is None else env)
    share = cpu_share()
    if share is not None:
        out["OMP_NUM_THREADS"] = str(share)
    return out


set_cpu_share()


def _worker(monkeypatch, workers, cpus):
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(workers))
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)))


def test_share_inside_a_worker(monkeypatch):
    for workers, cpus, want in [(6, 8, 1), (4, 8, 2), (2, 8, 4), (1, 8, 8),
                                (6, 4, 1), (3, 32, 10)]:
        _worker(monkeypatch, workers, cpus)
        assert cpu_share() == want, (workers, cpus)


def test_no_share_outside_xdist(monkeypatch):
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    before = torch.get_num_threads()
    assert cpu_share() is None
    set_cpu_share()
    assert torch.get_num_threads() == before
    env = share_env({"OMP_NUM_THREADS": "2", "X": "y"})
    assert env == {"OMP_NUM_THREADS": "2", "X": "y"}


def test_set_cpu_share_sets_torch(monkeypatch):
    before = torch.get_num_threads()
    try:
        _worker(monkeypatch, 4, 8)
        set_cpu_share()
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(before)


def test_subprocess_env_carries_the_share(monkeypatch):
    """The env handed to a subprocess carries the share; the worker's own
    environment stays as it was."""
    _worker(monkeypatch, 6, 8)
    monkeypatch.setenv("OMP_NUM_THREADS", "8")
    base = {"OMP_NUM_THREADS": "2", "PYTHONPATH": "p"}
    assert share_env(base) == {"OMP_NUM_THREADS": "1", "PYTHONPATH": "p"}
    assert base["OMP_NUM_THREADS"] == "2"
    env = share_env()
    assert env["OMP_NUM_THREADS"] == "1"
    assert env["PYTEST_XDIST_WORKER_COUNT"] == "6"
    assert os.environ["OMP_NUM_THREADS"] == "8"


def test_the_port_test_files_apply_the_share():
    """Every other port test file calls set_cpu_share at import, and one
    that starts processes hands them share_env's env."""
    here = os.path.dirname(os.path.abspath(__file__))
    texts = {n: open(os.path.join(here, n)).read()
             for n in sorted(os.listdir(here))
             if n.startswith("test_torch_") and n.endswith(".py")
             and n != os.path.basename(__file__)}
    unset = [n for n, t in texts.items() if "\nset_cpu_share()\n" not in t]
    starting = [n for n, t in texts.items() if "subprocess." in t]
    assert len(texts) >= 25 and not unset, unset
    assert starting and all("share_env(" in texts[n] for n in starting)
