"""test_torch_explicit_derivs.py's check of the ode45 derivatives against
redmax_tpu (1e-10 of scale, float64 on the CPU) on the other half of the
ode45 certificate scenes: the planar (16), translational (17) and free (18)
joints, the composite bodies (19, 25), the spline curve (21) and surface
(22), the point-to-point springs (23) and FREE2D (35). One jax.jit each;
one intra-op thread (single_thread).
"""

import pytest

from test_torch_certificates import single_thread  # noqa: F401
from test_torch_explicit_derivs import check_derivs


@pytest.mark.parametrize("sid", [16, 17, 18, 19, 21, 22, 23, 25, 35])
def test_derivs_match_jax(sid):
    check_derivs(sid)
