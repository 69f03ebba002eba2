"""The recursive (O(n) RHD) ode45 certificates of the first half of the
cases (test_torch_ode45_certificates.py says what is held). One intra-op
thread (single_thread).
"""

import pytest

from test_torch_certificates import single_thread  # noqa: F401
from test_torch_ode45_certificates import FIRST, check


@pytest.mark.parametrize("sid", FIRST)
def test_ode45_certificate_recursive(sid):
    check(sid, "recursive")
