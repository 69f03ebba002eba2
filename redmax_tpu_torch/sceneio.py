"""Scene description IO (the JAX package's sceneio.py): the reference's text
scene format, and a JSON format of this framework's own.

load_scene_text parses the C++ variant's #link/#spring/#closejoint stanza
format (c++/PCG/resources/syntax.txt; the parser role of
RigidBodyCreator::loadLinkagesfromFile / loadPhysicsfromFile,
RigidBodyCreator.h:25-73) into a SceneBuilder. save_scene_json /
load_scene_json write and read the builder's bodies and joints; the JSON is
the JAX package's, so a file written by either package loads in the other.
"""

import json
import math
from typing import Dict, Optional

import numpy as np

from redmax_tpu_torch.scene import SceneBuilder, _BodySpec, transl
from redmax_tpu_torch.types import JointType

_TYPE_MAP = {
    # c++ Joint.h:20 enum {Hinge, Fixed, Prismatic, Ball, ...}
    "hinge": JointType.REVOLUTE,
    "fixed": JointType.FIXED,
    "prismatic": JointType.PRISMATIC,
    "ball": JointType.SPHERICAL,
    "universal": JointType.UNIVERSAL,
}


def _floats(cur: Dict, key: str, default):
    return [float(x) for x in cur.get(key, default)]


def load_scene_text(path: str, h: float = 1e-2, tEnd: float = 1.0) -> SceneBuilder:
    """Parse the #link/#spring/#closejoint text format into a SceneBuilder.

    Stanzas: #link (name/dens/size/prnt/cpos/ppos/angl/type/stif/damp),
    #spring (lnka/lnkb/posa/posb/rest/stif/damp), #closejoint (a loop
    closure, ConstraintLoop), #springpoint (lnka/posa/axis/stif: a spring
    along a world axis, ForcePointDirection), #spline (prnt/type/ppos and
    bare lines of critical points: kept in builder.spline_paths); any other
    stanza (#options) is read and ignored.
    """
    b = SceneBuilder(name=path, h=h, tEnd=tEnd)
    names: Dict[str, int] = {}
    stanza: Optional[str] = None
    cur: Dict = {}

    def flush():
        nonlocal cur
        if not cur:
            return
        if stanza == "link":
            dens = float(cur.get("dens", ["1.0"])[0])
            size = np.array(_floats(cur, "size", ()))
            jt_tok = cur.get("type", ["ball"])
            jt = _TYPE_MAP.get(jt_tok[0], JointType.SPHERICAL)
            axis = (np.array([float(x) for x in jt_tok[1:4]]) if len(jt_tok) >= 4
                    else np.array([0.0, 0.0, 1.0]))
            body = b.body_cuboid(dens, size, E_ji=transl(_floats(cur, "cpos", [0, 0, 0])))
            parent = names.get(cur.get("prnt", [None])[0]) if "prnt" in cur else None
            kw = {"axis": axis} if jt in (JointType.REVOLUTE, JointType.PRISMATIC) else {}
            angl = float(cur.get("angl", ["0"])[0]) * math.pi
            q0 = [angl] if jt == JointType.REVOLUTE and angl else None
            j = b.joint(jt, parent, body, E_pj=transl(_floats(cur, "ppos", [0, 0, 0])), q=q0,
                        **kw)
            if "stif" in cur:
                b.set_stiffness(j, float(cur["stif"][0]))
            if "damp" in cur:
                b.set_damping(j, float(cur["damp"][0]))
            names[cur["name"][0]] = body
        elif stanza == "spring":
            b.force_spring_damper(
                names[cur["lnka"][0]], names[cur["lnkb"][0]],
                _floats(cur, "posa", [0, 0, 0]), _floats(cur, "posb", [0, 0, 0]),
                k=float(cur.get("stif", [0])[0]), d=float(cur.get("damp", [0])[0]),
                L=float(cur.get("rest", [0])[0]))
        elif stanza == "closejoint":
            b.constraint_loop(names[cur["lnka"][0]], names[cur["lnkb"][0]],
                              _floats(cur, "posa", [0, 0, 0]), _floats(cur, "posb", [0, 0, 0]))
        elif stanza == "springpoint":
            # syntax.txt #springpoint (c++ Constraint.h:53 SpringPoint, matlab
            # SpringPointDirection)
            b.force_point_direction(names[cur["lnka"][0]], _floats(cur, "posa", [0, 0, 0]),
                                    _floats(cur, "axis", [0, 0, 1]),
                                    float(cur.get("stif", [0])[0]))
        elif stanza == "spline":
            # syntax.txt #spline: an editing path of critical points on a joint
            # (RigidBodyCreator USER_SPLINE, RigidBodyCreator.h:92-108), kept as
            # the scene's metadata
            b.spline_paths.append({
                "parent": names.get(cur.get("prnt", [None])[0], -1),
                "type": cur.get("type", ["cubic b-spline"])[0],
                "ppos": _floats(cur, "ppos", [0, 0, 0]),
                "points": cur.get("_points", []),
            })
        cur = {}

    with open(path) as fh:
        for raw in fh:
            if raw.strip().startswith("#"):
                flush()
                stanza = raw.strip()[1:].split()[0]
                continue
            toks = raw.split()
            if not toks or stanza is None:
                continue
            try:
                # a bare coordinate line (#spline's critical points) has no key
                vals = [float(t) for t in toks]
            except ValueError:
                cur[toks[0]] = toks[1:] if len(toks) > 1 else [True]
            else:
                cur.setdefault("_points", []).append(vals)
    flush()
    return b


def save_scene_json(builder: SceneBuilder, path: str) -> None:
    """Write a SceneBuilder's bodies and joints (its forces and constraints
    are not part of the format) as JSON."""
    doc = {
        "name": builder.name,
        "h": builder.h,
        "tEnd": builder.tEnd,
        "grav": np.asarray(builder.grav).tolist(),
        "bodies": [{"inertia": bs.inertia.tolist(), "E_ji": np.asarray(bs.E_ji).tolist(),
                    "name": bs.name} for bs in builder.bodies],
        "joints": [{
            "type": int(js.jtype),
            "parent": js.parent,
            "E_pj": np.asarray(js.E_pj).tolist(),
            "q": np.asarray(js.q).tolist(),
            "qdot": np.asarray(js.qdot).tolist(),
            "stiffness": js.stiffness,
            "damping": js.damping,
            "params": {k: np.asarray(v).tolist() for k, v in js.params.items()},
        } for js in builder.joints],
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)


def load_scene_json(path: str) -> SceneBuilder:
    """A SceneBuilder from save_scene_json's JSON."""
    with open(path) as fh:
        doc = json.load(fh)
    b = SceneBuilder(name=doc["name"], h=doc["h"], tEnd=doc["tEnd"], grav=tuple(doc["grav"]))
    for bd in doc["bodies"]:
        b.bodies.append(_BodySpec(density=0.0, inertia=np.asarray(bd["inertia"]),
                                  E_ji=np.asarray(bd["E_ji"]), name=bd.get("name", "")))
    for i, jd in enumerate(doc["joints"]):
        kw = {k: np.asarray(v) for k, v in jd["params"].items()}
        spec_kw = ({"axis": kw["axis"]} if "axis" in kw
                   else {"plane": kw["plane"]} if "plane" in kw else {})
        j = b.joint(JointType(jd["type"]), None if jd["parent"] < 0 else jd["parent"], i,
                    E_pj=np.asarray(jd["E_pj"]), q=np.asarray(jd["q"]),
                    qdot=np.asarray(jd["qdot"]), **spec_kw)
        b.set_stiffness(j, jd["stiffness"])
        b.set_damping(j, jd["damping"])
        # the remaining params verbatim (splines, ...)
        b.joints[j].params.update({k: v for k, v in kw.items() if k not in ("axis", "plane")})
    return b
