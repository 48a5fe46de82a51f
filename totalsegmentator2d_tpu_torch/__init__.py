"""TotalSegmentator 2D on PyTorch and CUDA (NVIDIA Hopper).

The port of the JAX package ``totalsegmentator2d_tpu``: the same public API
and module layout, with plain tensor code in PyTorch and the TPU kernels
rewritten by hand for Hopper (``csrc/``, ``ops/cuda/``):

    from totalsegmentator2d_tpu_torch import TS2D
    with TS2D(key='ts2d', use_remote=False, local='models/') as model:
        res = model.predict('scan.nrrd')
        res.save('out/', name='scan')

Models run on the CUDA card unless the caller passes ``device='cpu'``.
"""

__version__ = '0.1.0'


def __getattr__(name):
    # lazy: `import totalsegmentator2d_tpu_torch` stays light
    if name == 'TS2D':
        from .api import TS2D
        return TS2D
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
