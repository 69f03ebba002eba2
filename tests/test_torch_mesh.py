"""The port's mesh module (numpy) against redmax_tpu's numpy path and the
analytic cuboid, and the OBJ scenes of the feature-rich zoo built on an OBJ
written here: an axis-aligned [1, 2, 3] cuboid with a corner at the origin,
its faces quads (fan-triangulated on reading). Cases 26 and 34 read the
reference's own OBJ files, which this repository does not hold; built on
this cuboid they must compile to what JAX's builders make of it.
"""

import jax
import numpy as np
import pytest
import torch

from redmax_tpu import mesh as jmesh
from redmax_tpu import scenes_matlab as jms
from redmax_tpu_torch import integrators as tint
from redmax_tpu_torch import mesh as tmesh
from redmax_tpu_torch import scenes_matlab as tms
from test_torch_model import _flat
from test_torch_mscene_modules import close, port_of


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch's intra-op threads set to 1 for the module, then restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIDES = (1.0, 2.0, 3.0)


@pytest.fixture
def cuboid_obj(tmp_path):
    x, y, z = SIDES
    verts = [(0, 0, 0), (x, 0, 0), (x, y, 0), (0, y, 0),
             (0, 0, z), (x, 0, z), (x, y, z), (0, y, z)]
    faces = [(1, 4, 3, 2), (5, 6, 7, 8), (1, 2, 6, 5), (2, 3, 7, 6), (3, 4, 8, 7), (4, 1, 5, 8)]
    path = tmp_path / "cuboid.obj"
    lines = ["# a [1, 2, 3] cuboid"] + [f"v {a} {b} {c}" for a, b, c in verts] + \
        [f"f {a}/{a} {b}/{b} {c}/{c} {d}/{d}" for a, b, c, d in faces]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_parse_and_mass_properties(cuboid_obj):
    V, F = tmesh.read_obj(cuboid_obj)
    jV, jF = jmesh._read_obj_py(cuboid_obj)
    np.testing.assert_array_equal(V, jV)
    np.testing.assert_array_equal(F, jF)
    assert V.shape == (8, 3) and F.shape == (12, 3)
    T = tmesh.volume_integrals(V, F)
    for a, b, name in zip(T, jmesh._volume_integrals_py(jV, jF), ("T0", "T1", "T2", "TP")):
        close(a, b, name, 1e-13)
    density = 0.7
    I6, E = tmesh.mesh_mass_properties(V, F, density)
    jI6, jE = jmesh.mesh_mass_properties(jV, jF, density)
    close(I6, jI6, "I6", 1e-12)
    close(E, jE, "E_oi", 1e-12)
    # the analytic cuboid: mass, the principal moments, the centre
    m = density * np.prod(SIDES)
    a2 = np.square(SIDES)
    analytic = np.sort([m / 12 * (a2[1] + a2[2]), m / 12 * (a2[2] + a2[0]), m / 12 * (a2[0] + a2[1])])
    close(I6, np.concatenate([analytic, [m, m, m]]), "analytic I6", 1e-12)
    close(E[:3, 3], 0.5 * np.asarray(SIDES), "centre", 1e-12)
    R = E[:3, :3]
    close(R.T @ R, np.eye(3), "orthonormal", 1e-12)
    assert np.linalg.det(R) > 0


def test_composite_mass_properties():
    rng = np.random.default_rng(4)
    parts = [np.array([1.0, 2.0, 3.0, 4.0, 4.0, 4.0]), np.array([0.5, 0.5, 0.2, 1.5, 1.5, 1.5]),
             np.array([2.0, 1.0, 1.0, 0.7, 0.7, 0.7])]
    Es = []
    for _ in parts:
        E = np.eye(4)
        E[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        E[:3, 3] = rng.normal(size=3)
        Es.append(E)
    I6, E = tmesh.composite_mass_properties(parts, Es)
    jI6, jE = jmesh.composite_mass_properties(parts, Es)
    close(I6, jI6, "I6", 1e-12)
    close(E, jE, "E_jc", 1e-12)
    assert I6[3] == pytest.approx(sum(p[3] for p in parts))


@pytest.mark.parametrize("sid", tms.OBJ_CASES)
def test_obj_scene_on_written_obj(sid, cuboid_obj, monkeypatch):
    """The case built on the written OBJ against JAX's builder made to read
    the same file; then 5 Euler steps of both."""
    monkeypatch.setattr(jmesh, "read_obj", lambda path: jmesh._read_obj_py(cuboid_obj))
    sc = jms.M_SCENES[sid]().compile()
    tc = tms.build_mscene(sid, obj=cuboid_obj, device="cpu")
    jp, tp = _flat(jax.tree_util.tree_map(np.asarray, sc.params)), _flat(tc.params)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        close(tp[k], jp[k], k, 1e-12)
    assert tc.topo == port_of(sc)[0]
    jstep = jax.jit(sc.make_step("euler"))
    s = sc.state0
    for _ in range(5):
        s = jstep(sc.params, s)
    final = tint.make_simulate(tc.make_step("euler"), 5)(tc.params, tc.initial_state("euler"))
    close(final.q[0].numpy(), s.q, "q", 1e-10)
    close(final.qdot[0].numpy(), s.qdot, "qdot", 1e-8)
