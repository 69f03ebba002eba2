"""The port's IO modules (sceneio, export, checkpoint, metrics) against the
JAX package's, in float64 on the CPU: each of the 11 tests of
tests/test_io.py on the port, held against redmax_tpu's output on the same
input (parsed scene params to roundoff, JSON across the two packages,
FrameExporter documents, OBJ bytes from both of the port's writers, the HTML
viewer's data, the Brender bundle, npz checkpoints across the two packages,
a bit-exact MPC resume with the port's Adam), and the metrics module
(energy_drift against the JAX package's, Timer, bench_throughput) and
draw_scene.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redmax_tpu import checkpoint as jcheckpoint
from redmax_tpu import export as jexport
from redmax_tpu import metrics as jmetrics
from redmax_tpu import model as jmodel
from redmax_tpu import sceneio as jsceneio
from redmax_tpu import scenes as jscenes
from redmax_tpu import types as jtypes
from redmax_tpu_torch import checkpoint, export, integrators, metrics, model, mpc, sceneio
from redmax_tpu_torch import scenes as tscenes
from redmax_tpu_torch.types import State
from test_torch_certificates import single_thread  # noqa: F401

TEXT_SCENE = """#options
simt redCGnomat
#link
name top
dens 3
size 3 0.8 0.5
ppos 0 0 0
cpos -1.4 0 0
angl 0.25
type hinge 0 0 1
#link
name middle
dens 3
size 3 0.8 0.5
prnt top
ppos 1.4 0 0
cpos -1.4 0 0
angl 0
type hinge 0 0 1
#spring
lnka top
lnkb middle
posa 1 0 0
posb -1 0 0
stif 100
damp 1
"""

SPLINE_SCENE = """#link
name root
dens 3
size 3 0.8 0.5
cpos -1.4 0 0
type hinge 0 0 1
#springpoint
lnka root
posa 1 0 0
axis 0 0 1
stif 50
#spline
prnt root
type cubic b-spline
ppos 0 0 1
1 0 0
2 0 0
3 1 0
"""


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)}


def _params_close(tparams, jparams, atol=1e-12):
    t, j = _leaves(tparams), _leaves(jparams)
    assert set(t) == set(j), set(t) ^ set(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], atol=atol, rtol=1e-12, err_msg=k)


def _compiled(text, tmp_path):
    path = tmp_path / "scene.txt"
    path.write_text(text)
    jb, tb = jsceneio.load_scene_text(str(path)), sceneio.load_scene_text(str(path))
    return jb, tb, jb.compile(), tb.compile(device="cpu")


def _euler_step_finite(sc):
    s = integrators.make_euler_step(sc.topo, sc.force_fns)(sc.params, sc.initial_state("euler"))
    assert torch.isfinite(s.q).all()


def test_text_format_parse(tmp_path):
    _, tb, jsc, tsc = _compiled(TEXT_SCENE, tmp_path)
    assert tsc.topo.njoints == 2 and tsc.topo.nr == 2 and len(tsc.force_fns) == 1
    assert [type(f).__name__ for f in tsc.force_fns] == [type(f).__name__ for f in jsc.force_fns]
    _params_close(tsc.params, jsc.params)
    np.testing.assert_allclose(tsc.state0.q.numpy(), np.asarray(jsc.state0.q), rtol=1e-15)
    _euler_step_finite(tsc)


def test_text_format_springpoint_spline(tmp_path):
    jb, tb, jsc, tsc = _compiled(SPLINE_SCENE, tmp_path)
    assert tb.spline_paths == jb.spline_paths
    sp = tb.spline_paths[0]
    assert sp["parent"] == 0 and len(sp["points"]) == 3
    assert len(tsc.force_fns) == 1
    _params_close(tsc.params, jsc.params)
    _euler_step_finite(tsc)


def test_json_roundtrip(tmp_path):
    """JSON written by either package loads in the other; both files are the
    same bytes."""
    jb, tb = jscenes.scene_chain(nlinks=3), tscenes.scene_chain(nlinks=3)
    sceneio.save_scene_json(tb, str(tmp_path / "port.json"))
    jsceneio.save_scene_json(jb, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    ref = jb.compile()
    for back in (sceneio.load_scene_json(str(tmp_path / "jax.json")),
                 sceneio.load_scene_json(str(tmp_path / "port.json"))):
        sc = back.compile(device="cpu")
        np.testing.assert_allclose(sc.params["E0_pj"].numpy(), np.asarray(ref.params["E0_pj"]))
        np.testing.assert_allclose(sc.state0.q.numpy(), np.asarray(ref.state0.q))
    jsc = jsceneio.load_scene_json(str(tmp_path / "port.json")).compile()
    np.testing.assert_allclose(np.asarray(jsc.params["E0_pj"]), np.asarray(ref.params["E0_pj"]))


def test_frame_export(tmp_path):
    """FrameExporter's document equals the JAX package's (transforms to
    roundoff), and export_objs writes one frame."""
    jsc, tsc = jscenes.build_scene(0), tscenes.build_scene(0, device="cpu")
    docs = []
    for pkg, sc, kin in (
            (jexport, jsc, jmodel.forward_kinematics(jsc.topo, jsc.params, jsc.state0.q,
                                                     jsc.state0.qdot)),
            (export, tsc, model.forward_kinematics(tsc.topo, tsc.params, tsc.state0.q[None],
                                                   tsc.state0.qdot[None]))):
        ex = pkg.FrameExporter(sc, str(tmp_path / pkg.__name__))
        ex.add_frame(0.0, kin)
        with open(ex.write()) as fh:
            docs.append(json.load(fh))
    jdoc, tdoc = docs
    assert {k: v for k, v in tdoc.items() if k != "frames"} == \
        {k: v for k, v in jdoc.items() if k != "frames"}
    assert len(tdoc["frames"]) == 1 and tdoc["frames"][0]["t"] == jdoc["frames"][0]["t"]
    np.testing.assert_allclose(tdoc["frames"][0]["E_wi"], jdoc["frames"][0]["E_wi"], atol=1e-12)
    n = export.export_objs(tsc, tsc.state0.q.numpy()[None], str(tmp_path))
    assert n == 1 and os.path.exists(tmp_path / "frame_00000.obj")


def test_frame_export_native_matches_python(tmp_path, monkeypatch):
    """The port's C writer (its copy of csrc/export.c, built by g++ into
    _build/) and its Python writer emit the JAX package's OBJ bytes."""
    jsc, tsc = jscenes.build_scene(0), tscenes.build_scene(0, device="cpu")
    traj = np.stack([np.asarray(jsc.state0.q), np.asarray(jsc.state0.q) + 0.1])
    sides = np.tile([1.0, 2.0, 0.5], (jsc.topo.njoints, 1))
    if export._native_export() is None:
        pytest.skip("no C++ compiler to build the port's export.c")
    d_nat, d_py, d_jax = tmp_path / "nat", tmp_path / "py", tmp_path / "jax"
    assert export.export_objs(tsc, traj, str(d_nat), sides=sides) == 2
    monkeypatch.setattr(jexport, "_EXPORT_LIB", False)          # JAX's Python writer
    assert jexport.export_objs(jsc, traj, str(d_jax), sides=sides) == 2
    monkeypatch.setattr(export, "_native_export", lambda: None)
    assert export.export_objs(tsc, traj, str(d_py), sides=sides) == 2
    for k in range(2):
        want = (d_jax / f"frame_{k:05d}.obj").read_bytes()
        assert (d_nat / f"frame_{k:05d}.obj").read_bytes() == want
        assert (d_py / f"frame_{k:05d}.obj").read_bytes() == want


def _viewer_data(path):
    html = open(path).read()
    return html, json.loads(html.split("const DATA=")[1].split(";\n")[0])


def test_export_html_viewer(tmp_path):
    """A self-contained viewer whose embedded DATA equals the JAX package's,
    the ground plane found from the contact force's params."""
    jsc = jscenes.scene_chain_ground(nlinks=3, floor_z=-1.0).compile()
    tsc = tscenes.scene_chain_ground(nlinks=3, floor_z=-1.0).compile(device="cpu")
    q0 = np.asarray(jsc.state0.q)
    traj = np.stack([q0, q0 + 0.1, q0 + 0.2])
    html, data = _viewer_data(export.export_html(tsc, traj, str(tmp_path / "v.html")))
    _, ref = _viewer_data(jexport.export_html(jsc, traj, str(tmp_path / "j.html")))
    assert "<canvas" in html and "http" not in html.split("</title>")[1]
    assert len(data["frames"]) == 3 and len(data["frames"][0]) == tsc.topo.njoints
    assert len(data["frames"][0][0]) == 12
    assert data["floor_z"] == -1.0 and data["h"] is not None
    assert data == ref


def test_checkpoint_roundtrip(tmp_path):
    """A port round trip, and an npz written by redmax_tpu.checkpoint loads
    in the port (and the port's in JAX)."""
    tree = {"q": torch.arange(5.0, dtype=torch.float64), "step": torch.tensor(7)}
    back = checkpoint.load_checkpoint(checkpoint.save_checkpoint(str(tmp_path / "ck"), tree), tree)
    assert torch.equal(back["q"], tree["q"]) and int(back["step"]) == 7
    jtree = {"q": jnp.arange(5.0), "step": jnp.asarray(7)}
    jp = jcheckpoint.save_checkpoint(str(tmp_path / "jck"), jtree, backend="npz")
    back = checkpoint.load_checkpoint(jp, tree)
    np.testing.assert_array_equal(back["q"].numpy(), np.arange(5.0))
    assert int(back["step"]) == 7
    jback = jcheckpoint.load_checkpoint(str(tmp_path / "ck"), jtree, backend="npz")
    np.testing.assert_array_equal(np.asarray(jback["q"]), np.arange(5.0))
    with pytest.raises(ImportError, match="orbax"):
        checkpoint.save_checkpoint(str(tmp_path / "o"), tree, backend="orbax")


def test_brender_export_addon_schema(tmp_path):
    """export_brender's bundle in the addon's schema (quat as [x, y, z, w]),
    equal to the JAX package's to roundoff."""
    jb, tb = jscenes.scene_chain(nlinks=3), tscenes.scene_chain(nlinks=3)
    jsc, tsc = jb.compile(), tb.compile(device="cpu")
    traj = 0.3 * np.random.default_rng(0).normal(size=(4, tsc.topo.nr))
    with open(export.export_brender(tsc, traj, str(tmp_path / "t"), bodies=tb.bodies)) as fh:
        doc = json.load(fh)
    with open(jexport.export_brender(jsc, traj, str(tmp_path / "j"), bodies=jb.bodies)) as fh:
        ref = json.load(fh)
    assert set(doc) == {"header", "body"}
    for op in doc["header"]["objs"]:
        assert os.path.isfile(op) and open(op).readline().startswith("v ")
    for a, b in zip(doc["header"]["objs"], ref["header"]["objs"]):
        assert open(a).read() == open(b).read()
    assert doc["header"]["states"] == ref["header"]["states"]
    assert len(doc["body"]) == 4 and doc["body"][0]["frame"] == 1
    for fr, fj in zip(doc["body"], ref["body"]):
        assert set(fr) == set(fj) and fr["frame"] == fj["frame"]
        for name in fr:
            if name == "frame":
                continue
            assert set(fr[name]) == {"scale", "quat", "location"}
            assert fr[name]["scale"] == fj[name]["scale"]
            for key in ("quat", "location"):
                np.testing.assert_allclose(fr[name][key], fj[name][key], atol=1e-12)
    kin = model.forward_kinematics(tsc.topo, tsc.params, torch.tensor(traj[:1]),
                                   torch.zeros(1, tsc.topo.nr, dtype=torch.float64))
    for i, st in enumerate(doc["header"]["states"]):
        np.testing.assert_allclose(doc["body"][0][st["name"]]["location"],
                                   kin.E_wi[0, i, :3, 3].numpy(), atol=1e-12)


def test_checkpoint_npz_backend(tmp_path):
    """leaf_NNNNN keys in JAX's leaf order (dict keys sorted), a structure
    mismatch raises, and a Python int comes back as an int."""
    tree = {"b": {"d": torch.ones(2), "c": torch.tensor(3)}, "a": torch.arange(4.0),
            "n": (5, 2.5)}
    p = checkpoint.save_checkpoint(str(tmp_path / "ck"), tree, backend="npz")
    assert p.endswith(".npz")
    with np.load(p) as data:
        assert sorted(data.files) == [f"leaf_{i:05d}" for i in range(5)]
        np.testing.assert_array_equal(data["leaf_00000"], np.arange(4.0))   # "a"
        assert int(data["leaf_00001"]) == 3                                # "b"/"c"
    back = checkpoint.load_checkpoint(p, tree, backend="npz")
    assert list(back) == ["b", "a", "n"] and torch.equal(back["b"]["d"], torch.ones(2))
    assert back["n"] == (5, 2.5) and type(back["n"][0]) is int
    jtree = {"a": jnp.arange(4.0), "b": {"c": jnp.asarray(3), "d": jnp.ones(2)},
             "n": (jnp.asarray(5), jnp.asarray(2.5))}
    jback = jcheckpoint.load_checkpoint(p, jtree, backend="npz")
    np.testing.assert_array_equal(np.asarray(jback["b"]["d"]), np.ones(2))
    with pytest.raises(ValueError):
        checkpoint.load_checkpoint(p, {"a": torch.zeros(4)}, backend="npz")


@pytest.mark.parametrize("backend", ["auto", "npz"])
def test_mpc_checkpoint_resume(tmp_path, backend):
    """The port's batched MPC Adam solve (2-link chain, f32, 3 steps, the
    op-level route), snapshotted every 2 iterations: a run stopped after 3
    and resumed through checkpointed_run lands on the uninterrupted run's P
    and Adam moments bit for bit, its count an int."""
    sc = tscenes.scene_chain(nlinks=2).compile(dtype=torch.float32, device="cpu")
    cfg = integrators.NewtonConfig(fixed_iters=2, predictor="quadratic", chord=True,
                                   hessian="structured", linsolve="gj")
    task = mpc.PointPosTask(body=1, wp=1.0, wreg=1e-6, pscale=1e3)
    obj = mpc.make_objective_batched(sc.topo, (), task, (0.5, 0.0, 0.0), 3, cfg,
                                     use_kernel=False)
    B = 2
    rng = np.random.default_rng(0)
    P0 = torch.tensor(0.003 * rng.normal(size=(B, sc.topo.nr)), dtype=torch.float32)
    s0 = State(q=sc.state0.q.expand(B, -1).contiguous(),
               qdot=sc.state0.qdot.expand(B, -1).contiguous())
    tgt = torch.tensor(rng.normal(size=(B, 3)), dtype=torch.float32)
    init, update = mpc._adam(0.05)

    def iterate(carry, _i):
        P, opt_state = carry
        Pg = P.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(obj(sc.params, Pg, s0, tgt).sum(), Pg)
        step, opt_state = update(g, opt_state)
        return P + step, opt_state

    carry0 = (P0, init(P0))
    ref = carry0
    for i in range(6):
        ref = iterate(ref, i)
    d = str(tmp_path / backend)
    checkpoint.checkpointed_run(iterate, carry0, 3, d, every=2, backend=backend)
    full = checkpoint.checkpointed_run(iterate, carry0, 6, d, every=2, backend=backend)
    assert type(full[1][2]) is int and full[1][2] == 6
    for a, b in zip(checkpoint.tree_flatten(full), checkpoint.tree_flatten(ref)):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)


def test_energy_drift_matches_jax():
    """energy_drift of scene 0 after 5 BDF2 steps of the port against the
    JAX package's energy_drift of the same state (one lane as a float,
    lanes as a tensor)."""
    jsc, tsc = jscenes.build_scene(0), tscenes.build_scene(0, device="cpu")
    fin = integrators.make_simulate(tsc.make_step("bdf2"), 5)(tsc.params,
                                                              tsc.initial_state("bdf2", B=2))
    lane = State(q=fin.q[0], qdot=fin.qdot[0], aux={})
    want = jmetrics.energy_drift(jsc, jtypes.State(q=jnp.asarray(lane.q.numpy()),
                                                   qdot=jnp.asarray(lane.qdot.numpy()), aux={}))
    got = metrics.energy_drift(tsc, lane)
    assert isinstance(got, float) and abs(got - want) <= 1e-9 * max(1.0, abs(want))
    lanes = metrics.energy_drift(tsc, fin)
    assert lanes.shape == (2,) and float((lanes - got).abs().max()) <= 1e-9 * max(1.0, abs(want))


def test_timer_and_bench_throughput():
    timer = metrics.Timer()
    for _ in range(2):
        timer.tic("a")
        assert timer.toc("a") >= 0.0
    rep = timer.report()["a"]
    assert rep["count"] == 2 and rep["avg_s"] == pytest.approx(rep["total_s"] / 2)
    dt, rate = metrics.bench_throughput(lambda x: (x * 2, {"y": x}), (torch.ones(3),),
                                        n_warmup=1, n_reps=2)
    assert dt > 0.0 and rate == pytest.approx(1.0 / dt)


def test_draw_scene():
    pytest.importorskip("matplotlib")
    tsc = tscenes.build_scene(0, device="cpu")
    ax = export.draw_scene(tsc, tsc.state0.q)
    assert len(ax.lines) == 12 * tsc.topo.njoints
