"""gpd_tpu_torch's data generation held to the benchmark's plain reference
labelling judge (h100_bench/reference/datagen.py) on the CPU, without JAX:
one zoo object of the data-generation cell at a tiny size (a ~1.4k-point
view, 32 samples, two attempts), its images scored by a LeNet of seeded
random weights. ``generate_view`` passes every number of the cell within
its limit, and a fault planted in the program fails the number that
watches it: the candidates relabelled against the view cloud instead of
the ground-truth cloud (labels_off), the first attempt's images under the
second attempt's rows (images_off), and the balance skipped (rows_off).
The ground-truth cloud is larger than the view's capacity, so the
relabelling's neighbourhoods reach past the view's neighbour cap.
"""

import numpy as np
import pytest
import torch

from gpd_tpu_torch import datagen
from gpd_tpu_torch.net import lenet
from test_torch_threads import set_cpu_share

set_cpu_share()

CELL = "gpd15_datagen.zoo_views"
# One box of the zoo: 3000 surface points (the ground-truth cloud, 4096
# slots), seen by one camera (~1.4k raw points, 2048 slots).
OBJECT = dict(zoo_seed=0, points=3000, camera_seed=1, view=0)
VIEW_CAPACITY, MESH_CAPACITY = 2048, 4096
NUM_SAMPLES = 32
GEN_SEED, RNG_SEED = 3, 11


@pytest.fixture(scope="module")
def case():
    """(config with the test's sizes, limits, a data generator of seeded
    random weights whose first attempt falls short of its positives by
    one, the view, the ground-truth cloud, the raw view, the ground truth
    as given)."""
    from gpd_tpu_torch.core.types import CloudArrays
    from gpd_tpu_torch.detector import GraspDetector
    from h100_bench import harness
    from h100_bench.entries.serve import program_config
    from h100_bench.inputs.zoo_views import zoo_views
    w = harness.load_json(harness.BENCH, "workloads", f"{CELL}.json")
    config = harness.load_json(harness.BENCH, "configs",
                               f"{w['config']}.json")
    config["detector"]["num_samples"] = NUM_SAMPLES
    limits = {**w["limits"], **w.get("tiny_limits", {})}
    mix = dict(objects=1, zoo_seed=OBJECT["zoo_seed"],
               points_per_object=OBJECT["points"], views_per_object=1,
               camera_seed=OBJECT["camera_seed"],
               view_capacity=VIEW_CAPACITY, min_view_points=200)
    (item,), (truth,) = zoo_views(mix)
    params = lenet.init_params(torch.Generator().manual_seed(7), 15)
    det = GraspDetector(program_config(config["detector"], ""),
                        params=params, device="cpu")
    view = det.preprocess_cloud(item["points"],
                                view_points=item["view_points"],
                                cam_source=item["cam_source"],
                                capacity=VIEW_CAPACITY)
    mesh = CloudArrays.from_numpy(
        truth["points"], normals=truth["normals"],
        view_points=np.zeros((1, 3), np.float32), capacity=MESH_CAPACITY,
        device="cpu")
    gen = datagen.DataGenerator(det, datagen.DataGenConfig(
        min_grasps_per_view=1, max_grasps_per_view=500))
    run_view(gen, view, mesh)
    # Two attempts: one positive more than the first attempt finds.
    gen.gen.min_grasps_per_view = gen.last_counts["positives"] + 1
    raw = dict(points=item["points"], cams=item["cam_source"],
               view_points=item["view_points"])
    config["datagen"] = dict(min_grasps_per_view=gen.gen.min_grasps_per_view,
                             max_grasps_per_view=500)
    return config, limits, gen, view, mesh, raw, truth


def run_view(gen, view, mesh):
    return gen.generate_view(view, mesh, torch.Generator().manual_seed(
        GEN_SEED), np.random.default_rng(RNG_SEED))


def judged(case):
    """One unit through ``generate_view`` and the judge's numbers of it."""
    from h100_bench.reference import datagen as ref
    config, _, gen, view, mesh, raw, truth = case
    images, labels = run_view(gen, view, mesh)
    c = gen.last_counts
    assert c["kept"] == len(labels) and c["mesh_points"] == 3000
    assert c["candidates"] == len(gen.last_candidates["label"])

    def host(hands):
        return {k: v.numpy() for k, v in hands.items()}
    np.testing.assert_array_equal(gen.last_rows["label"].numpy(), labels)
    out = ref.Outputs(n_points=int(view.mask.sum()),
                      candidates=host(gen.last_candidates),
                      rows=host(gen.last_rows), images=images,
                      attempts=c["attempts"], rng_seed=RNG_SEED)
    return ref.judge(out, raw, truth, config, "cpu",
                     torch.Generator().manual_seed(0))


def test_every_number_within_its_limit(case):
    nums = judged(case)
    assert case[2].last_counts["attempts"] == 2
    assert case[2].last_counts["kept"] > 0
    limits = case[1]
    assert {k: nums[k] for k in limits if nums[k] > limits[k]} == {}, nums


def view_labels(monkeypatch):
    """Every candidate relabelled against the view cloud."""
    real = datagen.DataGenerator._attempt
    monkeypatch.setattr(datagen.DataGenerator, "_attempt",
                        lambda self, view, mesh, *a: real(self, view, view,
                                                          *a))


def stale_images(monkeypatch):
    """The second attempt's rows given the first attempt's images."""
    real = datagen.DataGenerator._attempt
    first = []

    def attempt(self, *a):
        labels, images, hands = real(self, *a)
        first.append(images)
        old = first[0]
        return labels, old[torch.arange(len(images)) % len(old)], hands
    monkeypatch.setattr(datagen.DataGenerator, "_attempt", attempt)


def balance_skipped(monkeypatch):
    """Every candidate kept, positives first."""
    monkeypatch.setattr(datagen, "balance_instances",
                        lambda m, pos, neg, rng: np.concatenate([pos, neg]))


@pytest.mark.parametrize("fault,number", [
    (view_labels, "labels_off"),
    (stale_images, "images_off"),
    (balance_skipped, "rows_off"),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_fails_its_number(case, fault, number, monkeypatch):
    fault(monkeypatch)
    nums = judged(case)
    assert nums[number] > case[1][number], nums
