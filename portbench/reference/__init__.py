"""The benchmark's plain reference: the same mechanics as the port, written
again in plain PyTorch (float64 by default), importing nothing of the port.

It decides `correct`: the harness hands it the inputs it handed the program
and compares the program's outputs with its own. Everything it needs is
worked out here again from the configuration file (the scene's frames,
inertias and coefficients, the Newton matrices, the adjoint).
"""
