"""The reference's ode45 energy certificates on redmax_tpu_torch, in float64
on the CPU (the gate of tests/test_ode45.py, testRedMaxScenes.m's
REDMAX_ODE45 and RECURS_ODE45): each scene runs explicit.simulate_ode45 over
[0, tEnd] at RelTol 1e-4, AbsTol 1e-6, one lane, and H = T_end + V_end -
V_init must lie within 1e-2 of the certificate (5e-2 for mscenes 19 and 21,
whose accept/reject sequences are ulp-sensitive; tests/test_ode45.py says
why). Every case of test_ode45.py's CERTS but 26 and 34, whose OBJ files
the repository lacks: 19 dense, 18 recursive (mscene 12 has no recursive
certificate). This file: the first half of the dense cases and the dense
against recursive check on mscene 4 (test_cross_oracle_equivalence, 1e-6);
the _dense_b, _recursive and _recursive_b files: the rest. One intra-op
thread (single_thread).
"""

import pytest

from redmax_tpu_torch import explicit as tex
from redmax_tpu_torch import scenes_matlab as tms
from test_torch_certificates import single_thread  # noqa: F401

# (recursive, dense) certificates of tests/test_ode45.py
CERTS = {
    -1: (-5.6531026717020723, -5.6531026765951538),
    0: (-3.0971281943493523, -3.0971281068341341),
    1: (-1.9548841516880202, -1.9548841526830074),
    2: (-3.2850447686942061, -3.2850447782984702),
    4: (4176.3993502426255873, 4176.3993502425073530),
    10: (1210.7099042740396726, 1210.7099042740403547),
    11: (2898.56113448227, 2898.56113448227),
    12: (None, -0.0345395920267038),
    14: (-0.8577782593856682, -0.8577782794236555),
    15: (2.5092171102578504, 2.5092171060550754),
    16: (-5.7644270883174613, -5.7644270894088550),
    17: (835.418079875333, 835.418079875333),
    18: (4.5466342688068826, 4.5466342688068924),
    19: (-8.7962825142149086, -8.7962825142917609),
    21: (-18.5261468157405034, -18.5261468464450445),
    22: (-1.4604474130101153, -1.4604474127263529),
    23: (-0.2671194855411159, -0.2671194856266084),
    25: (-11.2086902929768257, -11.2086902930313954),
    35: (167.0835245643339135, 167.0835245643319240),
}
LOOSE = {19: 5e-2, 21: 5e-2}
FIRST = (-1, 0, 1, 2, 4, 10, 11, 14, 15)
SECOND = tuple(sorted(set(CERTS) - set(FIRST)))

_RUNS = {}


def run_H(sid, method):
    """H = T + V - V0 of one lane after ode45 over the scene's [0, tEnd]
    (kept per (sid, method) for the module)."""
    if (sid, method) not in _RUNS:
        sc = tms.build_mscene(sid, device="cpu")
        s0 = sc.initial_state("euler")
        _, V0 = sc.energies(s0.q, s0.qdot, s0.aux)
        fin = tex.simulate_ode45(sc, method)
        T, V = sc.energies(fin.q, fin.qdot, fin.aux)
        _RUNS[(sid, method)] = float(T[0] + V[0] - V0[0])
    return _RUNS[(sid, method)]


def check(sid, method):
    cert = CERTS[sid][0 if method == "recursive" else 1]
    H = run_H(sid, method)
    assert abs(H - cert) <= LOOSE.get(sid, 1e-2), f"mscene {sid}/{method}: {H!r} vs {cert!r}"


@pytest.mark.parametrize("sid", FIRST)
def test_ode45_certificate_dense(sid):
    check(sid, "dense")


def test_cross_oracle_equivalence():
    """Dense and recursive runs of mscene 4 agree (independent algorithms)."""
    assert abs(run_H(4, "dense") - run_H(4, "recursive")) < 1e-6
