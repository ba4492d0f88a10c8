"""The plain reference against the port at a tiny size on the CPU: the
victims' logits, the metric pass, HiT-ADV's preparation and iteration and
IFGSM's step, as a run of each cell compares them."""

import numpy as np
import pytest
import torch

from bench_port import harness, trees
from bench_port.reference import metrics as RM

CELLS = ["pointnet.hitadv.b256", "dgcnn.ifgsm.b256", "pointnet.ifgsm.b256"]


@pytest.mark.parametrize("config", ["pointnet", "dgcnn"])
def test_victim_logits(config):
    cfg = harness.read_json(harness.HERE / "configs" / f"{config}.json")
    mod = harness.load_module(harness.HERE / "configs" / f"{config}.py")
    ref = harness.load_module(harness.HERE / "reference" / f"{config}.py")
    gen = torch.Generator().manual_seed(5)
    params = trees.make_tree(mod.tree(cfg), gen, "cpu")
    x, _ = harness.make_clouds(3, 128, 40, gen, "cpu")
    x = x[..., :3].contiguous()
    got = mod.port_victim(cfg, params, "cpu")(x)
    want = ref.forward(params, x, cfg)
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * want.abs().max())


def test_make_tree_is_pytorch_default():
    spec = {"a": {"w": ("uniform", (64, 32), 64), "b": ("uniform", (32,),
                                                         64)},
            "bn": {"var": ("const", (32,), 1.0), "mean": ("const", (32,),
                                                          0.0)}}
    tree = trees.make_tree(spec, torch.Generator().manual_seed(0), "cpu")
    assert tree["a"]["w"].shape == (64, 32)
    assert tree["a"]["w"].abs().max() <= 1 / 8
    assert tree["a"]["w"].abs().max() > 0.1
    assert torch.equal(tree["bn"]["var"], torch.ones(32))
    assert torch.equal(tree["bn"]["mean"], torch.zeros(32))


def test_clouds_layout():
    x, y = harness.make_clouds(5, 64, 40, torch.Generator().manual_seed(1),
                               "cpu")
    assert x.shape == (5, 64, 6) and y.shape == (5,)
    norms = torch.linalg.vector_norm(x[..., :3], dim=-1)
    assert torch.allclose(norms.amax(1), torch.ones(5), atol=1e-5)
    x2, y2 = harness.make_clouds(5, 64, 40,
                                 torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)


def test_metric_pass_against_the_port():
    from hitadv_torch import losses as L

    gen = torch.Generator().manual_seed(3)
    x, _ = harness.make_clouds(2, 256, 40, gen, "cpu")
    ori, normal = x[..., :3].contiguous(), x[..., 3:].contiguous()
    adv = ori + 0.01 * torch.randn(ori.shape, generator=gen)
    got = torch.stack([torch.mean(L.knn_dist(adv, k=4)).double(),
                       L.uniform_loss(adv, k=5).double(),
                       torch.mean(L.curv_std_dist(ori, adv, normal,
                                                  k=4)).double()])
    want = RM.batch_metrics(ori, adv, normal, 5)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("cell", CELLS)
def test_run_agrees_with_the_reference(run_tiny, cell):
    out = run_tiny(cell)
    nums, detail = out["numbers"]["numbers"], out["numbers"]["detail"]
    assert out["failed"] == 0
    assert nums["exact_off"] == 0
    assert nums["judge_gap"] < 1e-5
    assert np.max(detail["metric"]) < 1e-6
    # a sign step can differ where the two gradients round across 0
    assert np.median(detail["step"]) < 1e-5
