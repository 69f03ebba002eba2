"""recursive.rhd_qddot and make_minv_product of redmax_tpu_torch against
redmax_tpu and against the dense solve (test_torch_recursive.py's check), in
float64 on the CPU, on the mscenes that hold the remaining joint kinds and
forces of the ode45 certificate scenes: the free joint (18), the
composite body (19, 25), the spline curve (21) and surface (22), the
point-to-point springs (23) and FREE2D (35). One jax.jit each; one
intra-op thread (single_thread).
"""

import pytest

from test_torch_certificates import single_thread  # noqa: F401
from test_torch_recursive import check_rhd_minv


@pytest.mark.parametrize("sid", [18, 19, 21, 22, 23, 25, 35])
def test_rhd_and_minv_match_jax_and_dense(sid):
    check_rhd_minv(("m", sid))
