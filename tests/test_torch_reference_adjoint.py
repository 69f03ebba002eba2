"""The port's reference-semantics adjoint against redmax_tpu's, in float64 on
the CPU: the default NewtonConfig() (the damped Newton with line search, the
exact Newton matrix, LU; its backward builds the exact H at the solution)
through the SDIRK2 bootstrap and two inner steps on chain-3, and two inner
steps on chain-ground-3 with the default config and with the structured
matrix and GJ without factor reuse: the gradient of sum(q^2) in the per-lane
torques and the velocities against jax.grad at 1e-8 of scale
(test_torch_backward_modes.check_gradients). A file of its own: the JAX
traces take most of a minute.
"""

import pytest
import torch

from test_torch_backward_modes import CONFIGS, check_gradients


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_default_config_gradients_through_bootstrap_match_jax():
    check_gradients("chain3", CONFIGS["default"], bootstrap=True)


@pytest.mark.parametrize("config", ["default", "structured_gj"])
def test_contact_gradients_match_jax(config):
    check_gradients("ground3", CONFIGS[config], bootstrap=False)
