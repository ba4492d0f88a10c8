"""The comparison that decides ``correct`` catches a broken timed path:
a run on the CPU at a tiny size, with the chip check skipped, comes out
correct, and comes out not correct once for each fault the cells can
have: a step that returns its state unchanged, half of the batch left
out of the loss's mean, the attack's answer altered where it is made,
and the evaluation's metric altered where it is made; and, for HiT-ADV,
once for a search of the loss weights that never counts a success."""

import pytest
import torch

from bench_port import checks

CELLS = ["pointnet.hitadv.b256", "dgcnn.ifgsm.b256", "pointnet.ifgsm.b256"]


class Fault:
    """One fault, patched into the port's modules while it is entered."""

    def __init__(self, kind):
        self.kind, self.undo = kind, []

    def _patch(self, mod, name, value):
        self.undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def __enter__(self):
        from hitadv_torch import evaluation
        from hitadv_torch.attacks import fgm, hit_adv

        if self.kind == "stuck":
            real = hit_adv.make_inner_iter

            def make_inner_iter(*a, **kw):
                real(*a, **kw)
                return lambda s: s
            self._patch(hit_adv, "make_inner_iter", make_inner_iter)
            real_grad = fgm._grad
            self._patch(fgm, "_grad", lambda f, a, pc, y: torch.zeros_like(
                real_grad(f, a, pc, y)))
        elif self.kind == "half":
            def half_mean(x):
                return torch.mean(x[: max(1, x.shape[0] // 2)]) \
                    if x.dim() else x
            self._patch(hit_adv, "batch_mean", half_mean)
            self._patch(fgm, "batch_mean", half_mean)
        elif self.kind == "answer":
            for mod in (hit_adv, fgm):
                real_result = mod.AttackResult

                def altered(adv_points, success, pred, _real=real_result):
                    adv_points = adv_points.clone()
                    adv_points[0, 0, 0] += 1e-3
                    return _real(adv_points, success, pred)
                self._patch(mod, "AttackResult", altered)
        elif self.kind == "metric":
            real_knn = evaluation.L.knn_dist
            self._patch(evaluation.L, "knn_dist",
                        lambda pc, k=5: real_knn(pc, k=k) * 1.001)
        elif self.kind == "search":
            real_search = hit_adv.binary_search_update
            self._patch(hit_adv, "binary_search_update",
                        lambda found, *a: real_search(
                            torch.zeros_like(found), *a))
        return self

    def __exit__(self, *exc):
        for mod, name, value in reversed(self.undo):
            setattr(mod, name, value)
        self.undo.clear()


def _correct(out):
    return all(ok for *_, ok in checks.verdict(out["numbers"]["numbers"],
                                               out["run"].cell.limits))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(run_tiny, cell):
    assert _correct(run_tiny(cell))


@pytest.mark.parametrize("kind", ["stuck", "half", "answer", "metric"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(run_tiny, cell, kind):
    assert not _correct(run_tiny(cell, fault=Fault(kind)))


def test_search_fault_is_not_correct(run_tiny):
    out = run_tiny("pointnet.hitadv.b256", fault=Fault("search"))
    assert not _correct(out)
    assert out["numbers"]["numbers"]["exact_off"] > 0
