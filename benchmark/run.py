"""The port's benchmark, one run of one cell of BENCHMARK.json:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It prints one JSON line last on stdout (see benchmark/harness.py).
"""

import time

T0 = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, 'benchmark', 'build')

if __name__ == '__main__':
    # every cache of a compiler or a kernel library at a fixed path inside
    # the checkout, so that only a checkout's first run builds
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'),
                     ('CUDA_CACHE_PATH', 'cuda_cache')):
        os.environ[var] = os.path.join(BUILD, sub)
    sys.path.insert(0, ROOT)
    from benchmark import harness
    sys.exit(harness.main(sys.argv[1:], T0, ROOT))
