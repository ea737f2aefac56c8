"""Caps torch's intra-op threads in the port's tests.

Every tests/test_torch_*.py imports this module. The whole suite runs in
several pytest-xdist workers on one machine, each of which imports every
test file, and by default torch gives each of its CPU ops one thread per
core: the workers' torch threads then contend with each other and with the
JAX package's tests for the same cores. One thread per worker leaves each
worker one core's worth of torch work.
"""

import torch

THREADS = 1

torch.set_num_threads(THREADS)
