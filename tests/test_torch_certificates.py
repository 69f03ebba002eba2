"""The reference's energy certificates on redmax_tpu_torch, in float64 on
the CPU (the gate of tests/test_certificates.py, Scene.m:164-191): each
scene runs its nsteps with the default NewtonConfig() (the reference
solver: line search, tol 1e-9, exact Newton matrix, LU) under BDF1 and BDF2,
one lane, and the final H = T_end + V_end - V_init must lie within 1e-2 of
the scene's Hexpected. Here scenes 1-5 and 14 under both, and the smoke
scenes -2 and -1 (no certificate: a finite H after a BDF1 run). Scenes 0,
6, 8, 10, 12, 13 under BDF1 and scene 9 on its Euler chart:
test_torch_certificates_bdf1.py; scene 7 on Euler charts:
test_torch_certificates_euler.py (scene 11's 1200 steps are left out).

These runs are thousands of small tensor ops a second: each module runs with
one intra-op thread (single_thread), since several test processes that each
spin a thread per core slow one another about tenfold.
"""

import math

import pytest
import torch

from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch.scenes import build_scene


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_H(sid, integrator: str):
    """(H, Hexpected) of scene sid (7 and 9 on Euler charts) after its
    nsteps under integrator, on the CPU in float64."""
    sc = build_scene(sid, device="cpu", **({"exp_coords": False} if sid in (7, 9) else {}))
    s0 = sc.initial_state(integrator)
    T0, V0 = sc.energies(s0.q, s0.qdot, s0.aux)
    final = tint.make_simulate(sc.make_step(integrator), sc.nsteps)(sc.params, s0)
    T, V = sc.energies(final.q, final.qdot, final.aux)
    return float(T + V - V0), sc.Hexpected.get(integrator)


def check_certificate(sid, integrator):
    H, expected = run_H(sid, integrator)
    assert abs(H - expected) <= 1e-2, f"scene {sid} {integrator}: H={H!r} vs {expected!r}"


@pytest.mark.parametrize("integrator", ["bdf1", "bdf2"])
@pytest.mark.parametrize("sid", [1, 2, 3, 4, 5, 14])
def test_certificate(sid, integrator):
    check_certificate(sid, integrator)


@pytest.mark.parametrize("sid", [-2, -1])
def test_smoke_scenes(sid):
    assert math.isfinite(run_H(sid, "bdf1")[0])
