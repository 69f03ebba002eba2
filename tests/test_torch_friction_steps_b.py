"""The friction step against redmax_tpu's make_euler_fric_step on mscenes
30 (the 4-bar: loop ring, equality rows), 31 (a floor contact) and 33 (the
driven walker through scene_fn_33): the checks of
test_torch_friction_steps.py."""

import pytest
import torch

from test_torch_friction_steps import check_case


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sid", [30, 31, 33])
def test_first_steps_match_jax(sid):
    check_case(sid)
