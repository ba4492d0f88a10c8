"""On the card: the control, the reference in TF32 put in the program's
place, comes out as not correct, while the program's run at the same
size comes out correct (16 clouds of 1024 points, 20 attack
iterations). Run on a machine with a card:

    python -m pytest bench_port/tests -m cuda
"""

import time

import pytest

from bench_port import checks, harness

CELLS = ["pointnet.hitadv.b256", "dgcnn.ifgsm.b256", "pointnet.ifgsm.b256"]


def _small(cell):
    tr = cell.traffic
    tr.update(batch=16, pool_batches=2)
    if tr["step_check"] == "hitadv":
        tr["attack"].update(binary_step=1, num_iter=20)
    else:
        tr["attack"].update(num_iter=20)
    tr["iterations_per_batch"] = 20
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = _small(harness.load_cell(cell))
    out = harness.run_cell(c, 2 ** 31 + 5, 0.01, False, time.perf_counter())
    verdict = checks.verdict(out["numbers"]["numbers"], c.limits)
    assert all(ok for *_, ok in verdict), verdict
    ctl = checks.readings(out["run"], out["params"], control=checks.tf32)
    cverdict = checks.verdict(ctl["numbers"], c.limits)
    assert not all(ok for *_, ok in cverdict), cverdict
