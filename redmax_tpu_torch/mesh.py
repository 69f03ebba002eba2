"""Mesh and composite bodies: OBJ loading and mass properties, in numpy.

BodyMeshObj.processMesh (matlab/+redmax/BodyMeshObj.m:24-104) reads an OBJ
mesh and integrates its volume moments (Mirtich 1996) into a diagonal
inertia and the inertial frame E_oi; BodyComposite (BodyComposite.m:28-77)
merges rigid parts into one body. These run once, at scene build time, on
the host.
"""

from typing import Tuple

import numpy as np


def _hat(p):
    return np.array([[0.0, -p[2], p[1]], [p[2], 0.0, -p[0]], [-p[1], p[0], 0.0]])


def _Ad(E):
    """The 6x6 adjoint [[R, 0], [hat(p) R, R]] of a transform E [4, 4]."""
    R, p = E[:3, :3], E[:3, 3]
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[3:, 3:] = R
    A[3:, :3] = _hat(p) @ R
    return A


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(V [nv, 3] float64, F [nf, 3] int64) of an OBJ file, each polygon
    fan-triangulated; vertex indices 1-based in the file, 0-based here."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int64)


def volume_integrals(V: np.ndarray, F: np.ndarray):
    """(T0, T1 [3], T2 [3], TP [3]): the volume, first, second and product
    moments of a closed triangle mesh by Mirtich's projection integrals
    (BodyMeshObj.VolumeIntegration), face by face."""
    T0 = 0.0
    T1 = np.zeros(3)
    T2 = np.zeros(3)
    TP = np.zeros(3)
    for tri in F:
        v = V[tri]                    # [3,3]
        n = np.cross(v[1] - v[0], v[2] - v[0])
        ln = np.linalg.norm(n)
        if ln < 1e-30:
            continue
        n = n / ln
        C = int(np.argmax(np.abs(n)))
        A, B = (C + 1) % 3, (C + 2) % 3
        # projection integrals
        P1 = Pa = Pb = Paa = Pab = Pbb = Paaa = Paab = Pabb = Pbbb = 0.0
        for i in range(3):
            a0, b0 = v[i][A], v[i][B]
            a1, b1 = v[(i + 1) % 3][A], v[(i + 1) % 3][B]
            da, db = a1 - a0, b1 - b0
            a0_2, a0_3, a0_4 = a0 * a0, a0**3, a0**4
            b0_2, b0_3, b0_4 = b0 * b0, b0**3, b0**4
            a1_2, a1_3 = a1 * a1, a1**3
            b1_2, b1_3 = b1 * b1, b1**3
            C1 = a1 + a0
            Ca = a1 * C1 + a0_2
            Caa = a1 * Ca + a0_3
            Caaa = a1 * Caa + a0_4
            Cb = b1 * (b1 + b0) + b0_2
            Cbb = b1 * Cb + b0_3
            Cbbb = b1 * Cbb + b0_4
            Cab = 3 * a1_2 + 2 * a1 * a0 + a0_2
            Kab = a1_2 + 2 * a1 * a0 + 3 * a0_2
            Caab = a0 * Cab + 4 * a1_3
            Kaab = a1 * Kab + 4 * a0_3
            Cabb = 4 * b1_3 + 3 * b1_2 * b0 + 2 * b1 * b0_2 + b0_3
            Kabb = b1_3 + 2 * b1_2 * b0 + 3 * b1 * b0_2 + 4 * b0_3
            P1 += db * C1
            Pa += db * Ca
            Paa += db * Caa
            Paaa += db * Caaa
            Pb += da * Cb
            Pbb += da * Cbb
            Pbbb += da * Cbbb
            Pab += db * (b1 * Cab + b0 * Kab)
            Paab += db * (b1 * Caab + b0 * Kaab)
            Pabb += da * (a1 * Cabb + a0 * Kabb)
        P1 /= 2.0
        Pa /= 6.0; Paa /= 12.0; Paaa /= 20.0
        Pb /= -6.0; Pbb /= -12.0; Pbbb /= -20.0
        Pab /= 24.0; Paab /= 60.0; Pabb /= -60.0

        w = -float(n @ v[0])
        na, nb, nc = n[A], n[B], n[C]
        k1 = 1.0 / nc; k2 = k1 * k1; k3 = k2 * k1; k4 = k3 * k1
        Fa = k1 * Pa; Fb = k1 * Pb
        Fc = -k2 * (na * Pa + nb * Pb + w * P1)
        Faa = k1 * Paa; Fbb = k1 * Pbb
        Fcc = k3 * (na * na * Paa + 2 * na * nb * Pab + nb * nb * Pbb
                    + w * (2 * (na * Pa + nb * Pb) + w * P1))
        Faaa = k1 * Paaa; Fbbb = k1 * Pbbb
        Fccc = -k4 * (na**3 * Paaa + 3 * na * na * nb * Paab
                      + 3 * na * nb * nb * Pabb + nb**3 * Pbbb
                      + 3 * w * (na * na * Paa + 2 * na * nb * Pab + nb * nb * Pbb)
                      + w * w * (3 * (na * Pa + nb * Pb) + w * P1))
        Faab = k1 * Paab
        Fbbc = -k2 * (na * Pabb + nb * Pbbb + w * Pbb)
        Fcca = k3 * (na * na * Paaa + 2 * na * nb * Paab + nb * nb * Pabb
                     + w * (2 * (na * Paa + nb * Pab) + w * Pa))

        T0 += n[0] * (Fa if A == 0 else (Fb if B == 0 else Fc))
        T1[A] += na * Faa; T1[B] += nb * Fbb; T1[C] += nc * Fcc
        T2[A] += na * Faaa; T2[B] += nb * Fbbb; T2[C] += nc * Fccc
        TP[A] += na * Faab; TP[B] += nb * Fbbc; TP[C] += nc * Fcca
    return T0, T1 / 2.0, T2 / 3.0, TP / 2.0


def mesh_mass_properties(V, F, density: float):
    """(I6 [6], E_oi [4, 4]): the diagonal inertia in the inertial frame and
    the inertial frame in the OBJ's frame (BodyMeshObj.processMesh,
    :24-104)."""
    T0, T1, T2, TP = volume_integrals(V, F)
    mass = density * T0
    r = T1 / T0
    J = np.zeros((3, 3))
    J[0, 0] = density * (T2[1] + T2[2])
    J[1, 1] = density * (T2[2] + T2[0])
    J[2, 2] = density * (T2[0] + T2[1])
    J[0, 1] = J[1, 0] = -density * TP[0]
    J[1, 2] = J[2, 1] = -density * TP[1]
    J[2, 0] = J[0, 2] = -density * TP[2]
    J[0, 0] -= mass * (r[1] ** 2 + r[2] ** 2)
    J[1, 1] -= mass * (r[2] ** 2 + r[0] ** 2)
    J[2, 2] -= mass * (r[0] ** 2 + r[1] ** 2)
    J[1, 0] += mass * r[0] * r[1]
    J[0, 1] = J[1, 0]
    J[2, 1] += mass * r[1] * r[2]
    J[1, 2] = J[2, 1]
    J[0, 2] += mass * r[2] * r[0]
    J[2, 0] = J[0, 2]
    w, Vv = np.linalg.eigh(J)
    E = np.eye(4)
    if np.cross(Vv[:, 0], Vv[:, 1]) @ Vv[:, 2] < 0:
        Vv[:, 2] = -Vv[:, 2]
    E[:3, :3] = Vv
    E[:3, 3] = r
    I6 = np.array([w[0], w[1], w[2], mass, mass, mass])
    return I6, E


def composite_mass_properties(inertias, Es):
    """Composite of sub-bodies: (I6, E_jc) wrt the parent joint frame.

    BodyComposite.computeInertiaFrame (matlab/+redmax/BodyComposite.m:28-77):
    total mass, the frame at the centre of mass, the 6x6 inertias summed
    through adjoints, then the rotational block diagonalized.
    """
    masses = [float(I[3]) for I in inertias]
    mtotal = sum(masses)
    xc = sum(m / mtotal * np.asarray(E)[:3, 3] for m, E in zip(masses, Es))
    E_jc = np.eye(4)
    E_jc[:3, 3] = xc
    I_c = np.zeros((6, 6))
    for I6, E_jk in zip(inertias, Es):
        E_kc = np.linalg.inv(np.asarray(E_jk)) @ E_jc
        Ad = _Ad(E_kc)
        I_c += Ad.T @ np.diag(np.asarray(I6)) @ Ad
    w, Vv = np.linalg.eigh(I_c[:3, :3])
    if np.cross(Vv[:, 0], Vv[:, 1]) @ Vv[:, 2] < 0:
        Vv[:, 2] = -Vv[:, 2]
    E_jc[:3, :3] = Vv
    I6 = np.array([w[0], w[1], w[2], mtotal, mtotal, mtotal])
    return I6, E_jc
