"""The dense ode45 certificates of the second half of the cases
(test_torch_ode45_certificates.py says what is held): mscene 12 (attach
points), the planar, translational and free joints, the composite bodies,
the splines, the springs and FREE2D. One intra-op thread (single_thread).
"""

import pytest

from test_torch_certificates import single_thread  # noqa: F401
from test_torch_ode45_certificates import SECOND, check


@pytest.mark.parametrize("sid", SECOND)
def test_ode45_certificate_dense(sid):
    check(sid, "dense")
