"""Plans parsing, the U-Net module and weight conversion."""

from .plans import ArchSpec, ModelSpec, PreprocessSpec, parse_model_spec
from .unet import UNet

__all__ = ['ArchSpec', 'ModelSpec', 'PreprocessSpec', 'parse_model_spec',
           'UNet']
