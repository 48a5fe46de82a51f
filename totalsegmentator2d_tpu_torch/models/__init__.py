"""Plans parsing, the U-Net module and weight conversion."""

from .plans import ArchSpec, ModelSpec, PreprocessSpec, parse_model_spec
from .unet import UNet, forward, init_params, pad_to_stride, param_count

__all__ = ['ArchSpec', 'ModelSpec', 'PreprocessSpec', 'parse_model_spec',
           'UNet', 'forward', 'init_params', 'pad_to_stride', 'param_count']
