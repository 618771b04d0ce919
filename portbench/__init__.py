"""The benchmark of self6dpp_tpu_torch, the PyTorch and CUDA port: one run
of one cell is `python3 -m portbench --workload <name> --seed <n> --seconds
<s> --trace <0|1>` (harness.py). It loads neither JAX nor the JAX package;
the plain reference it checks the port against is in reference/."""

import time

# the process's start, as near as the benchmark can take it: setup_s runs
# from here to the first timed step
START = time.perf_counter()
