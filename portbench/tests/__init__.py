"""The benchmark's own tests (not collected by the repo's tests/ run):

    python -m pytest portbench/tests
"""

# a tiny size of every mix for runs on the CPU (the port's plain kernel route)
TINY = {"B": 16, "horizon": 5, "steps": 10, "ref_lanes": 8}
