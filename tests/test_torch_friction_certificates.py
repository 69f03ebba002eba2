"""The friction cases' energy certificates on redmax_tpu_torch, in float64 on
the CPU, in the bands of tests/test_friction.py (the reference's
REDMAX_EULER certificates, Hexpected["euler_fric"]): mscenes 31, 28 and 29
within 1e-2 absolute, mscene 27 within 7% relative, and mscene 27's sticking
limit (mu = 50, 400 sweeps: the chain does not move); mscenes 30 and 33 in
test_torch_friction_certificates_b.py. One lane each through
make_simulate(make_step("euler_fric")), every sweep solve on K3's g++
build."""

import pytest
import torch

from redmax_tpu_torch import friction, integrators
from redmax_tpu_torch.scenes_matlab import SCENE_FNS, build_mscene


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_H(sid, step=None, params=None):
    """(H = T + V - V0 after the case's nsteps from its initial state, the
    final state, the scene)."""
    sc = build_mscene(sid, device="cpu")
    s0 = sc.initial_state("euler")
    _, V0 = sc.energies(s0.q, s0.qdot)
    sim = integrators.make_simulate(step or sc.make_step("euler_fric"), sc.nsteps,
                                    scene_fn=SCENE_FNS.get(sid))
    final = sim(params or sc.params, s0)
    T, V = sc.energies(final.q, final.qdot)
    return float(T[0] + V[0] - V0[0]), final, sc


@pytest.mark.parametrize("sid", [31, 28, 29])
def test_certificate_absolute(sid):
    H, final, sc = run_H(sid)
    assert torch.isfinite(final.q).all()
    assert abs(H - sc.Hexpected["euler_fric"]) <= 1e-2, (H, sc.Hexpected["euler_fric"])


def test_internal_friction_dissipates():
    H, _, sc = run_H(27)
    expected = sc.Hexpected["euler_fric"]
    assert abs(H - expected) / abs(expected) < 0.07, (H, expected)


def test_internal_friction_sticking_limit():
    """mu -> large: static friction holds the chain still."""
    sc = build_mscene(27, device="cpu")
    params = {**sc.params, "mu": torch.tensor([50.0, 50.0], dtype=torch.float64)}
    step = friction.make_euler_fric_step(sc.topo, sc.force_fns, sc.friction_model,
                                         pgs_iters=400)
    _, final, _ = run_H(27, step=step, params=params)
    assert float(final.q.abs().max()) < 5e-3
