"""The energy certificates (test_torch_certificates.py) of scene 7, the
spherical double pendulum on Euler charts (SPHERICAL_EULER, h = 2e-3, 500
steps, charts switching along the way), under BDF1 and BDF2."""

import pytest

from test_torch_certificates import check_certificate, single_thread  # noqa: F401


@pytest.mark.parametrize("integrator", ["bdf1", "bdf2"])
def test_spherical_euler_certificate(integrator):
    check_certificate(7, integrator)
