"""The benchmark of the PyTorch and CUDA port ``d3net_tpu_torch``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. One run sets the cell up from its seed,
measures for ``--seconds`` and prints one JSON line last on standard
output (``perfbench/harness/bench.py`` says what it holds). The cell's
configuration, traffic, driver and metrics are files found by name
(``BENCHMARK.json`` and ``perfbench/{configs,traffic,workloads,drivers,
metrics}/``).
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "perfbench", ".cache")

# every cache at a fixed path inside the checkout, set before torch loads
sys.pycache_prefix = os.path.join(CACHE, "pycache")
os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from perfbench.harness.bench import main

    sys.exit(main(sys.argv[1:], T0))
