"""Write the DICOM fixtures of ``tests/fixtures/dicom/``: one small CT-like
slice (128 x 128) in each compressed transfer syntax that ``chip_smoke.py``
does not encode itself, so the card's machine (no Pillow, no CharLS) holds
the port's native codec paths against its Python paths on every syntax.

    python tools/make_torch_dicom_fixtures.py [OUT_DIR]

Writes ``<syntax>.dcm`` for RLE, deflate, JPEG baseline (8-bit), JPEG
extended (12-bit), JPEG-LS lossless and near-lossless, and JPEG 2000 5/3
and 9/7, and ``decoded.npz``: for each file the array the reference
package's reader gives (the lossless ones are the source slice exactly).
The encoders are the test suite's (tests/test_017_dicom.py), Pillow's
openjpeg and the system CharLS (``libcharls.so.2``, tests/charls_oracle.py);
nothing is downloaded. The slice comes from a seed, so the codestreams are
the same on every run.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests import charls_oracle  # noqa: E402
from tests.test_017_dicom import (_DEFL, _J2K, _J2KLL, _JLSLL, _JPB, _JPE,  # noqa: E402
                                  _RLE, _j2k_encode, _jpegdct_frame,
                                  write_slice)
from totalsegmentator2d_tpu.io import read_image  # noqa: E402

OUT = os.path.join(ROOT, 'tests', 'fixtures', 'dicom')
JLS_NEAR = '1.2.840.10008.1.2.4.81'
SHAPE = (128, 128)


def ct_slice(seed=7):
    """A torso-like axial slice in stored units (HU + 1024, 0..4095): air,
    an elliptic body, two lungs, a vertebra, noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:SHAPE[0], 0:SHAPE[1]].astype(np.float64)
    h, w = SHAPE
    body = ((y - h * 0.52) / (h * 0.38)) ** 2 + ((x - w / 2) / (w * 0.42)) ** 2
    hu = np.where(body <= 1, 40 + 12 * rng.standard_normal(SHAPE), -1024.0)
    for side in (-1, 1):
        lung = (((y - h * 0.45) / (h * 0.2)) ** 2
                + ((x - w * (0.5 + side * 0.18)) / (w * 0.14)) ** 2) <= 1
        hu = np.where(lung, -820 + 25 * rng.standard_normal(SHAPE), hu)
    spine = (((y - h * 0.78) / (h * 0.07)) ** 2
             + ((x - w / 2) / (w * 0.09)) ** 2) <= 1
    hu = np.where(spine, 900 + 40 * rng.standard_normal(SHAPE), hu)
    return (np.clip(np.round(hu), -1024, 3071) + 1024).astype(np.uint16)


def main(out=OUT):
    if not charls_oracle.available():
        raise SystemExit('the system CharLS library (libcharls.so.2) is '
                         'needed for the JPEG-LS fixtures')
    os.makedirs(out, exist_ok=True)
    ct = ct_slice()
    xray = (ct >> 4).astype(np.uint8)  # an 8-bit rendering for baseline
    hu = dict(slope=1, intercept=-1024)
    cases = {
        'rle': (ct, dict(transfer_syntax=_RLE, **hu)),
        'deflate': (ct, dict(transfer_syntax=_DEFL, **hu)),
        'jpeg-baseline8': (xray, dict(transfer_syntax=_JPB,
                                      codestream=_jpegdct_frame(
                                          xray, precision=8, q=4))),
        'jpeg-extended12': (ct, dict(transfer_syntax=_JPE, codestream=(
            _jpegdct_frame(ct, precision=12, q=8)), **hu)),
        'jpegls-lossless': (ct, dict(transfer_syntax=_JLSLL,
                                     codestream=charls_oracle.encode(ct, 12),
                                     **hu)),
        'jpegls-near': (ct, dict(transfer_syntax=_JLSLL,
                                 codestream=charls_oracle.encode(ct, 12,
                                                                 near=2),
                                 **hu)),
        'j2k-53': (ct, dict(transfer_syntax=_J2KLL,
                            codestream=_j2k_encode(ct), **hu)),
        'j2k-97': (ct, dict(transfer_syntax=_J2K, codestream=_j2k_encode(
            ct, irreversible=True), **hu)),
    }
    decoded = {}
    for name, (arr, kw) in cases.items():
        path = os.path.join(out, f'{name}.dcm')
        write_slice(path, arr, position=(-50.0, -50.0, 120.0),
                    pixel_spacing=(0.78, 0.78), **kw)
        if name == 'jpegls-near':  # the same stream under its own syntax
            with open(path, 'rb') as f:
                data = f.read()
            with open(path, 'wb') as f:
                f.write(data.replace(_JLSLL.encode(), JLS_NEAR.encode()))
        decoded[name] = read_image(path).array
        size = os.path.getsize(path)
        lossless = np.array_equal(decoded[name], arr.astype(np.int32)[None]
                                  + kw.get('intercept', 0))
        print(f'{name}: {size} bytes, {decoded[name].dtype} '
              f'{decoded[name].shape}, lossless {lossless}')
    np.savez_compressed(os.path.join(out, 'decoded.npz'), **decoded)
    total = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f'{len(cases)} fixtures and decoded.npz in {out}: {total} bytes')


if __name__ == '__main__':
    main(*sys.argv[1:])
