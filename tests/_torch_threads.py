"""One torch intra-op thread for the port's test files.

Every `tests/test_torch_*.py` imports this module first. The tier-1 run
puts six pytest workers on the machine at once, each running JAX beside
torch; torch's default of one intra-op thread a core then runs six pools
of eight threads on eight cores, and the small tensors of these tests
spend more time handing work between threads than computing it (a CPU
train step of tinyllama smoke took 3.6 s at the default and 0.3 s at one
thread under that load). The port's CPU bit-equality checks (lanes at 8
and 16 rows, streams against the reference, chunked against unchunked)
pass at one thread as at the default, so the cap changes no assertion.

It is a module of the port's tests, not `conftest.py`, which the
reference's suite shares and which stays as it is. Every xdist worker
collects every test file, so every worker of a run imports it; the
reference's test files run no torch. Import it for its effect:

    import _torch_threads  # noqa: F401
"""

import torch

THREADS = 1

torch.set_num_threads(THREADS)
