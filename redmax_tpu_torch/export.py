"""Frame export and visualization (the JAX package's export.py: the role of
the reference's Brender exporter, online/Brender/cpp/BrenderManager.h,
Brenderable.h:15-31, and of its OpenGL viewer):

  * FrameExporter writes per-frame JSON (body world transforms) in a
    Blender-importable layout;
  * export_brender writes the bundle the reference's Blender import addon
    reads;
  * export_objs writes per-frame OBJ files of the transformed cuboids,
    through a C writer (csrc/export.c, g++ at first use into _build/) where
    a compiler is found, else in Python: both emit the same bytes;
  * export_html writes a self-contained interactive viewer;
  * draw_scene renders a configuration with matplotlib (imported only
    there).

This is host IO: forward kinematics runs batched over the frames on the
trajectory's device, once, and the rest on the host in float64.
"""

import ctypes
import json
import os
from typing import Dict, List

import numpy as np
import torch

from redmax_tpu_torch import se3
from redmax_tpu_torch.kernel_build import KernelBuild
from redmax_tpu_torch.model import forward_kinematics

_CUBE_VERTS = np.array(
    [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)]
)
_CUBE_FACES = np.array(
    [
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ]
)


def _frames_E(scene, traj_q) -> torch.Tensor:
    """World transforms [T, nb, 4, 4] of the recorded positions traj_q
    [T, nr] (the frames as lanes of one forward kinematics, at zero velocity,
    in the scene's initial charts), on traj_q's device."""
    q = torch.as_tensor(traj_q, dtype=scene.state0.q.dtype).to(scene.state0.q.device)
    T = q.shape[0]
    aux = {k: v.expand(T, *v.shape).contiguous() for k, v in scene.state0.aux.items()}
    with torch.no_grad():
        return forward_kinematics(scene.topo, scene.params, q, torch.zeros_like(q), aux).E_wi


class FrameExporter:
    """Accumulates frames and writes a Brender-style JSON bundle."""

    def __init__(self, scene, out_dir: str):
        self.scene = scene
        self.out_dir = out_dir
        self.frames: List[Dict] = []
        os.makedirs(out_dir, exist_ok=True)

    def add_frame(self, t: float, kin) -> None:
        """kin: forward kinematics of one configuration (E_wi [nb, 4, 4], or
        [1, nb, 4, 4] as one lane)."""
        E = kin.E_wi
        if E.dim() == 4:
            if E.shape[0] != 1:
                raise ValueError(f"add_frame takes one configuration, got {E.shape[0]} lanes")
            E = E[0]
        self.frames.append({"t": float(t), "E_wi": E.detach().cpu().double().tolist()})

    def write(self) -> str:
        doc = {
            "name": self.scene.name,
            "bodies": [
                {
                    "name": getattr(bs, "name", f"body{i}"),
                    "sides": None if getattr(bs, "sides", None) is None
                    else np.asarray(bs.sides).tolist(),
                }
                for i, bs in enumerate(getattr(self.scene, "body_specs", []))
            ],
            "frames": self.frames,
        }
        path = os.path.join(self.out_dir, "frames.json")
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return path


_SPHERE_CACHE = {}


def _unit_sphere(nsub: int = 2):
    """Unit icosphere (vertices, faces) by midpoint subdivision."""
    if nsub in _SPHERE_CACHE:
        return _SPHERE_CACHE[nsub]
    t = (1.0 + np.sqrt(5.0)) / 2.0
    V = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
        dtype=np.float64,
    )
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    F = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
    )
    for _ in range(nsub):
        verts = list(V)
        cache = {}
        newF = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]

        for a, b, c in F:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            newF += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        V = np.array(verts)
        F = np.array(newF)
    _SPHERE_CACHE[nsub] = (V, F)
    return _SPHERE_CACHE[nsub]


def _write_obj(path: str, V: np.ndarray, F: np.ndarray) -> None:
    with open(path, "w") as fh:
        for v in V:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in F:
            fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")


def export_brender(scene, traj_q, out_dir: str, bodies=None, group: str = "scene") -> str:
    """Write the bundle the reference's Blender import addon ingests
    (online/Brender/python/blender_import_obj_base.py), in the layout of
    RigidBodyMain::exportBrender (RigidBodyMain.cpp:747-840):

        {"header": {"objs": [<abs obj paths>],
                    "states": [{"obj": i, "name": n, "group": g}, ...]},
         "body": [{"frame": k,
                   "<name>": {"scale": [sx,sy,sz],
                              "quat": [qx,qy,qz,qw],   # addon reads [3],[0],[1],[2]
                              "location": [x,y,z]}, ...}, ...]}

    The template meshes (unit cube, unit sphere) are written beside the JSON
    and named by absolute path; each body's scale carries its cuboid sides
    or sphere radius. scene: CompiledScene; bodies: the SceneBuilder's
    bodies (names, sides, radius; unit cubes without them); traj_q [T, nr]
    recorded positions. Returns the JSON path.
    """
    os.makedirs(out_dir, exist_ok=True)
    cube_path = os.path.abspath(os.path.join(out_dir, "cube.obj"))
    sphere_path = os.path.abspath(os.path.join(out_dir, "sphere.obj"))
    _write_obj(cube_path, _CUBE_VERTS, _CUBE_FACES)
    sV, sF = _unit_sphere()
    _write_obj(sphere_path, sV, sF)

    names, states, scales = [], [], []
    for i in range(scene.topo.njoints):
        bs = None if bodies is None or i >= len(bodies) else bodies[i]
        name = (getattr(bs, "name", "") or f"body{i}") if bs else f"body{i}"
        names.append(name)
        radius = getattr(bs, "radius", None) if bs else None
        sides = getattr(bs, "sides", None) if bs else None
        if radius is not None:
            states.append({"obj": 1, "name": name, "group": group})
            scales.append([float(radius)] * 3)
        else:
            states.append({"obj": 0, "name": name, "group": group})
            s = np.ones(3) if sides is None else np.asarray(sides, np.float64)
            scales.append([float(v) for v in s])

    Et = _frames_E(scene, traj_q).double()
    Q = se3.mat_to_q(Et[..., :3, :3]).cpu().numpy()          # [T, nb, 4] wxyz
    E = Et.cpu().numpy()
    frames = []
    for k in range(E.shape[0]):
        fr = {"frame": k + 1}                                # the addon does frame - 1
        for i, name in enumerate(names):
            w, x, y, z = Q[k, i]
            fr[name] = {"scale": scales[i], "quat": [float(x), float(y), float(z), float(w)],
                        "location": [float(v) for v in E[k, i, :3, 3]]}
        frames.append(fr)
    doc = {"header": {"objs": [cube_path, sphere_path], "states": states}, "body": frames}
    path = os.path.join(out_dir, f"{scene.name or 'scene'}.json")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


# The C OBJ writer: a host build of kernel_build (g++ into _build/).
EXPORT_BUILD = KernelBuild("export", ("export.c",), host=True)


def _native_export():
    """The C writer's library, built at first use, or None where no compiler
    is found or the build fails (export_objs then writes in Python)."""
    try:
        lib = EXPORT_BUILD.load()
    except (RuntimeError, OSError):
        return None
    lib.write_frames_obj.restype = ctypes.c_int
    lib.write_frames_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                     ctypes.POINTER(ctypes.c_double), ctypes.c_long,
                                     ctypes.c_long, ctypes.c_long]
    return lib


def _objs_python(out_dir: str, E: np.ndarray, S: np.ndarray, stride: int) -> int:
    """The Python OBJ writer: export.c's bytes."""
    n = 0
    for k in range(0, E.shape[0], stride):
        with open(os.path.join(out_dir, f"frame_{n:05d}.obj"), "w") as fh:
            voff = 1
            for b in range(E.shape[1]):
                Vw = (_CUBE_VERTS * S[b]) @ E[k, b, :3, :3].T + E[k, b, :3, 3]
                for v in Vw:
                    fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
                for f in _CUBE_FACES:
                    fh.write(f"f {f[0]+voff} {f[1]+voff} {f[2]+voff}\n")
                voff += 8
        n += 1
    return n


def export_objs(scene, traj_q, out_dir: str, sides=None, stride: int = 1) -> int:
    """Write per-frame OBJs of cuboid bodies (BrenderManager's OBJ mode) as
    out_dir/frame_%05d.obj: traj_q [T, nr] recorded positions, every
    stride-th frame, sides [nb, 3] (unit cubes by default). Forward
    kinematics runs once over all frames; the formatting loop runs in C
    (csrc/export.c) where it builds, else in Python. Returns the number of
    frames written."""
    os.makedirs(out_dir, exist_ok=True)
    E = np.ascontiguousarray(_frames_E(scene, traj_q).double().cpu().numpy())  # [T, nb, 4, 4]
    T, nb = E.shape[:2]
    S = np.ascontiguousarray(np.ones((nb, 3)) if sides is None
                             else np.asarray(sides, dtype=np.float64))
    lib = _native_export()
    if lib is not None:
        dbl = ctypes.POINTER(ctypes.c_double)
        n = lib.write_frames_obj(out_dir.encode(), E.ctypes.data_as(dbl), S.ctypes.data_as(dbl),
                                 T, nb, stride)
        if n >= 0:
            return n
    return _objs_python(out_dir, E, S, stride)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>redmax_tpu viewer — __NAME__</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace;overflow:hidden}
 #hud{position:fixed;left:10px;top:10px;user-select:none}
 #bar{position:fixed;left:10px;bottom:10px;right:10px;display:flex;gap:8px;align-items:center}
 #scrub{flex:1}
 button{background:#333;color:#ddd;border:1px solid #555;font:13px monospace;cursor:pointer}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">__NAME__ — drag: orbit · wheel: zoom · space: play/pause</div>
<div id="bar"><button id="play">&#9654;</button>
 <input type="range" id="scrub" min="0" max="0" value="0" step="1">
 <span id="fr"></span></div>
<script>
const DATA=__DATA__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
const scrub=document.getElementById('scrub'),frlab=document.getElementById('fr');
const playBtn=document.getElementById('play');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}rs();
addEventListener('resize',rs);
const T=DATA.frames.length,NB=DATA.sides.length;scrub.max=T-1;
// unit cube corners and quad faces
const CV=[];for(const x of[-0.5,0.5])for(const y of[-0.5,0.5])for(const z of[-0.5,0.5])CV.push([x,y,z]);
const QF=[[0,1,3,2],[4,6,7,5],[0,4,5,1],[2,3,7,6],[0,2,6,4],[1,5,7,3]];
// scene scale -> camera distance
let cx=0,cy=0,cz=0,n=0,rmax=1e-6;
for(const f of DATA.frames)for(let b=0;b<NB;b++){cx+=f[b][9];cy+=f[b][10];cz+=f[b][11];n++;}
cx/=n;cy/=n;cz/=n;
for(const f of DATA.frames)for(let b=0;b<NB;b++){
 const r=Math.hypot(f[b][9]-cx,f[b][10]-cy,f[b][11]-cz);if(r>rmax)rmax=r;}
let theta=0.6,phi=0.35,dist=4.5*rmax+3;
let k=0,playing=true,drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 theta+=(e.clientX-drag[0])*0.01;phi+=(e.clientY-drag[1])*0.01;
 phi=Math.max(-1.55,Math.min(1.55,phi));drag=[e.clientX,e.clientY];});
addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);});
addEventListener('keydown',e=>{if(e.code==='Space'){playing=!playing;e.preventDefault();}});
playBtn.onclick=()=>playing=!playing;
scrub.oninput=()=>{k=+scrub.value;playing=false;};
function draw(){
 if(playing){k=(k+1)%T;scrub.value=k;}
 playBtn.textContent=playing?'\\u275A\\u275A':'\\u25B6';
 frlab.textContent='frame '+k+'/'+(T-1)+(DATA.h?('  t='+(k*DATA.h).toFixed(3)+'s'):'');
 ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
 const ct=Math.cos(theta),st=Math.sin(theta),cp=Math.cos(phi),sp=Math.sin(phi);
 // camera basis (z-up world): forward f, right r, up u
 const f=[-ct*cp,-st*cp,-sp],r=[-st,ct,0],u=[f[1]*r[2]-f[2]*r[1],f[2]*r[0]-f[0]*r[2],f[0]*r[1]-f[1]*r[0]];
 const eye=[cx-dist*f[0],cy-dist*f[1],cz-dist*f[2]];
 const fl=1.2*Math.min(W,H);
 function proj(p){
  const d=[p[0]-eye[0],p[1]-eye[1],p[2]-eye[2]];
  const z=d[0]*f[0]+d[1]*f[1]+d[2]*f[2];
  const x=d[0]*r[0]+d[1]*r[1]+d[2]*r[2], y=d[0]*u[0]+d[1]*u[1]+d[2]*u[2];
  return [W/2+fl*x/z, H/2-fl*y/z, z];
 }
 const F=DATA.frames[k],polys=[];
 for(let b=0;b<NB;b++){
  const M=F[b],S=DATA.sides[b];
  const P=CV.map(v=>{const x=v[0]*S[0],y=v[1]*S[1],z=v[2]*S[2];
   return proj([M[0]*x+M[1]*y+M[2]*z+M[9], M[3]*x+M[4]*y+M[5]*z+M[10], M[6]*x+M[7]*y+M[8]*z+M[11]]);});
  const hue=(b*67)%360;
  for(const q of QF){
   const zs=(P[q[0]][2]+P[q[1]][2]+P[q[2]][2]+P[q[3]][2])/4;
   if(zs<=0.01)continue;
   // flat shade by projected-area sign (cheap normal-ish cue)
   const ax=P[q[1]][0]-P[q[0]][0],ay=P[q[1]][1]-P[q[0]][1];
   const bx=P[q[3]][0]-P[q[0]][0],by=P[q[3]][1]-P[q[0]][1];
   const shade=45+Math.min(30,Math.abs(ax*by-ay*bx)/(zs*zs)*3e4);
   polys.push({z:zs,pts:q.map(i=>P[i]),c:'hsl('+hue+',60%,'+shade+'%)'});
  }
 }
 // ground grid (z = DATA.floor_z if present, else skip)
 if(DATA.floor_z!==null){
  ctx.strokeStyle='#2a4a2a';ctx.beginPath();
  const g=Math.ceil(rmax+1);
  for(let i=-g;i<=g;i++){
   const a=proj([cx+i,cy-g,DATA.floor_z]),b2=proj([cx+i,cy+g,DATA.floor_z]);
   const c2=proj([cx-g,cy+i,DATA.floor_z]),d2=proj([cx+g,cy+i,DATA.floor_z]);
   if(a[2]>0.01&&b2[2]>0.01){ctx.moveTo(a[0],a[1]);ctx.lineTo(b2[0],b2[1]);}
   if(c2[2]>0.01&&d2[2]>0.01){ctx.moveTo(c2[0],c2[1]);ctx.lineTo(d2[0],d2[1]);}
  }
  ctx.stroke();
 }
 polys.sort((a,b2)=>b2.z-a.z);
 for(const p of polys){
  ctx.fillStyle=p.c;ctx.strokeStyle='#000';ctx.beginPath();
  ctx.moveTo(p.pts[0][0],p.pts[0][1]);
  for(let i=1;i<4;i++)ctx.lineTo(p.pts[i][0],p.pts[i][1]);
  ctx.closePath();ctx.fill();ctx.stroke();
 }
 requestAnimationFrame(draw);
}
requestAnimationFrame(draw);
</script></body></html>
"""


def export_html(scene, traj_q, out_path: str, sides=None, stride: int = 1,
                floor_z=None) -> str:
    """A self-contained interactive HTML trajectory viewer (no dependencies,
    works offline): orbit and zoom camera, play and pause, frame scrubbing,
    a color per body and a ground grid, painted on a canvas by vanilla JS
    (the live-viewer role of the reference's OpenGL app,
    c++/PCG/src/main.cpp:194-439). traj_q [T, nr] recorded positions
    (make_simulate(record=True)); sides [nb, 3] cuboid sides (unit cubes by
    default); floor_z: the ground plane's height, found from a ground-contact
    force's params when not given. Returns out_path.
    """
    E = _frames_E(scene, torch.as_tensor(traj_q)[::stride]).double().cpu().numpy()
    T, nb = E.shape[:2]
    if sides is None:
        specs = getattr(scene, "body_specs", None)
        if specs:
            sides = [[1.0, 1.0, 1.0] if getattr(bs, "sides", None) is None
                     else list(np.asarray(bs.sides, dtype=float)) for bs in specs]
        else:
            sides = [[1.0, 1.0, 1.0]] * nb
    else:
        sides = np.asarray(sides, dtype=float).tolist()

    if floor_z is None:
        # a ground plane from a ground-contact force's params (z up)
        for fn in getattr(scene, "force_fns", ()):
            fp = scene.params.get("forces", {}).get(getattr(fn, "key", ""), {})
            if "E" in fp and "kn" in fp:
                floor_z = float(fp["E"][2, 3])
                break

    frames = [[[round(float(v), 5)
                for v in list(E[t, b, :3, :3].reshape(9)) + list(E[t, b, :3, 3])]
               for b in range(nb)]
              for t in range(T)]
    h = scene.params.get("h")
    data = {
        "sides": sides,
        "frames": frames,
        "h": None if h is None else float(h) * stride,
        "floor_z": floor_z,
    }
    html = (_HTML_TEMPLATE
            .replace("__NAME__", str(getattr(scene, "name", "scene")))
            .replace("__DATA__", json.dumps(data)))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        fh.write(html)
    return out_path


def draw_scene(scene, q, ax=None, sides=None):
    """A matplotlib 3D wireframe of the scene at configuration q [nr]
    (matplotlib is imported here only, with its Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.figure().add_subplot(projection="3d")
    E = _frames_E(scene, torch.as_tensor(q)[None])[0].double().cpu().numpy()
    for b in range(scene.topo.njoints):
        s = np.ones(3) if sides is None else np.asarray(sides[b])
        Vw = (_CUBE_VERTS * s) @ E[b, :3, :3].T + E[b, :3, 3]
        for f in _CUBE_FACES:
            tri = Vw[f]
            ax.plot(tri[[0, 1, 2, 0], 0], tri[[0, 1, 2, 0], 1], tri[[0, 1, 2, 0], 2],
                    "b-", linewidth=0.3)
    return ax
