"""The recursive (O(n) RHD) ode45 certificates of the second half of the
cases (test_torch_ode45_certificates.py says what is held; mscene 12 has
none, as in the reference). One intra-op thread (single_thread).
"""

import pytest

from test_torch_certificates import single_thread  # noqa: F401
from test_torch_ode45_certificates import CERTS, SECOND, check


@pytest.mark.parametrize("sid", [s for s in SECOND if CERTS[s][0] is not None])
def test_ode45_certificate_recursive(sid):
    check(sid, "recursive")
