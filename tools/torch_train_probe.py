"""The PyTorch port's training path on the GPU, without the other phases
of the smoke test:

    python tools/torch_train_probe.py

Runs ``chip_smoke.py``'s phase 1 (the card, the kernels' build), the
prefilter half of phase 2 (the kernel against its plain versions at every
call site, the training shapes included, with their times and bounds) and
phase 10 (training: the flagship group model at batch 16 in fp32 and bf16,
GPU against CPU, ``ts2d-torch-train`` on a PNG dataset), from the root of a
checkout. Needs one CUDA card; exits non-zero where the smoke test would.
"""

import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def main():
    t0 = time.perf_counter()
    shutil.rmtree(C.WORK, ignore_errors=True)
    os.makedirs(C.WORK)
    smi, _ = C.device_info()
    prefilter = C.check_prefilter()
    launches = C.training(smi)
    shutil.rmtree(C.WORK, ignore_errors=True)
    print(json.dumps({k: dict(prefilter[k], launches=n)
                      for k, n in launches.items()}))
    print(f'{smi}; {time.perf_counter() - t0:.1f} s')


if __name__ == '__main__':
    main()
