"""The energy certificates (test_torch_certificates.py) of scenes 0, 6, 8,
10, 12 and 13 under BDF1 (their BDF2 steps are held per step by
test_torch_ref_semantics.py), and of scene 9 on its Euler-chart FREE3D joint
under BDF1 and BDF2."""

import pytest

from test_torch_certificates import check_certificate, single_thread  # noqa: F401


@pytest.mark.parametrize("sid", [0, 6, 8, 10, 12, 13])
def test_bdf1_certificate(sid):
    check_certificate(sid, "bdf1")


@pytest.mark.parametrize("integrator", ["bdf1", "bdf2"])
def test_free3d_euler_certificate(integrator):
    check_certificate(9, integrator)
