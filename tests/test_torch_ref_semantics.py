"""The port's reference-semantics solver against the committed f64 trajectory
dumps tests/data/ref_traj_*.npz (benchmarks/make_ref_traj.py made them with
the JAX package's default NewtonConfig(): the damped Newton with line
search, tol 1e-9, the exact Newton matrix and LU).

The port's make_bdf2_step with the default NewtonConfig(), in float64 on the
CPU, on every dumped scene the port builds (0 and 6-13, with 7 and 9 in
exp-map coordinates, as the dumps are): the SDIRK2 bootstrap from q[0] and
every inner BDF2 step from the dumps' history (one lane per step) reproduce
the dumped q within 1e-9 of scale. (JAX's own default-config step gives at
most 3.4e-16 of scale on these dumps.)
"""

import os

import numpy as np
import pytest
import torch

from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import scenes as tscenes
from redmax_tpu_torch.types import State


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DATA = os.path.join(os.path.dirname(__file__), "data")
SCENES = {
    0: tscenes.scene_00_serial_chain,
    6: tscenes.scene_06_free2d,
    7: lambda: tscenes.scene_07_spherical(exp_coords=True),
    8: tscenes.scene_08_universal,
    9: lambda: tscenes.scene_09_free3d(exp_coords=True),
    10: tscenes.scene_10_loop,
    11: tscenes.scene_11_ground,
    12: tscenes.scene_12_spring_damper,
    13: tscenes.scene_13_cables,
}
TOL = 1e-9


@pytest.mark.parametrize("sid", sorted(SCENES))
def test_default_config_reproduces_ref_traj(sid):
    d = np.load(os.path.join(DATA, f"ref_traj_{sid:02d}.npz"))
    sc = SCENES[sid]().compile(dtype=torch.float64, device="cpu")
    step = tint.make_bdf2_step(sc.topo, sc.force_fns, tint.NewtonConfig())
    q, qd = d["q_bdf2"], d["qdot_bdf2"]
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    scale = max(1.0, float(np.abs(q).max()))

    s1 = step.bootstrap(sc.params, tint.bdf2_init(State(q=t(q[:1]), qdot=t(qd[:1]))))
    err_boot = float(np.abs(s1.q.numpy() - q[1:2]).max()) / scale

    s = tint.Bdf2State(q=t(q[1:-1]), qdot=t(qd[1:-1]), q_prev=t(q[:-2]),
                       qdot_prev=t(qd[:-2]), k=1)
    out = step.inner(sc.params, s)
    err = np.abs(out.q.numpy() - q[2:]).max(axis=-1) / scale
    assert err_boot <= TOL and err.max() <= TOL, (sid, err_boot, float(err.max()),
                                                  int(err.argmax()))
