"""The PCG tier of the port's LM solver on the card (marked `cuda`: they
skip where torch.cuda.is_available() is false). No jax and no conftest
fixtures, so they run on the machine with the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_pcg_cuda.py

Two problems, each solved on the card and on the CPU: the run-length
odometry block of __graft_entry__._synthetic_problem at 64 scans (forced
onto the PCG tier), poses within 1e-4 of the CPU's; and translation
averaging at Room-454's pair graph (chip_smoke.ta_room_inputs, ~9,000
pairs, P > 6144, so the PCG tier by default), camera centres within 1 mm of
the CPU's. A second solve on the card gives the same bits (ROADMAP F9:
every scattered sum of the tier is exact).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from panovlm_tpu_torch.device import resolve
    return resolve("cuda")


def _odometry(device):
    from __graft_entry__ import _synthetic_problem
    from panovlm_tpu_torch.solver import lm, residuals
    poses0, fixed, pr, pn, pts, pl = _synthetic_problem(n_scans=64, n_obs=20000)
    order = np.lexsort((pn, pr))
    pr, pn, pts, pl = (a[order] for a in (pr, pn, pts, pl))

    def t(a):
        return torch.from_numpy(a).to(device)
    block = lm.ResidualBlock(
        functools.partial(residuals.point2plane_angle, normalize_distance=True),
        ("poses", "poses"), (t(pr), t(pn)), (t(pts), t(pl)),
        torch.ones(len(pr), device=device), torch.ones(len(pr), dtype=torch.bool, device=device),
        loss="huber", loss_scale=float(np.radians(2.0)))
    out, info = lm.solve_lm({"poses": t(poses0)}, (block,), {"poses": t(fixed)},
                            lm.LMOptions(max_iters=10, dense_max_params=0))
    assert info["tier"] == "pcg"
    return out["poses"].cpu().numpy()


def _translation_averaging(device):
    import chip_smoke
    from panovlm_tpu_torch.models import translation_averaging as ta
    kwargs, _, R_cw = chip_smoke.ta_room_inputs()
    assert 3 * len(R_cw) + len(kwargs["pair_i"]) > 6144
    t, _ = ta.translation_averaging(**kwargs, device=device)
    return -np.einsum("nji,nj->ni", R_cw, t)


CASES = {"odometry": (_odometry, 1e-4), "translation_averaging": (_translation_averaging, 1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_pcg_on_card_matches_cpu_and_reruns_bit_equal(cuda_device, name):
    solve, tol = CASES[name]
    card = solve(cuda_device)
    again = solve(cuda_device)
    assert card.tobytes() == again.tobytes()
    np.testing.assert_allclose(card, solve(torch.device("cpu")), atol=tol)
