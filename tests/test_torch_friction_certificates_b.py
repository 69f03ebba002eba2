"""The friction certificates of mscenes 30 (the 4-bar with joint and loop
rings: within 15% relative) and 33 (the driven walker on floor contacts,
through scene_fn_33: within 3% relative), in the bands of
tests/test_friction.py; the checks of test_torch_friction_certificates.py."""

import pytest
import torch

from test_torch_friction_certificates import run_H


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sid, band", [(30, 0.15), (33, 0.03)])
def test_certificate_relative(sid, band):
    H, final, sc = run_H(sid)
    assert torch.isfinite(final.q).all()
    expected = sc.Hexpected["euler_fric"]
    assert abs(H - expected) / abs(expected) < band, (H, expected)
