"""Inference: the local model database and zoo, hosted models, and the fused
sliding-window ensemble engine."""

from .database import FileDataBase, decompose_model_key
from .ensemble_engine import EnsembleEngine
from .model import HostedModel
from .zoo import Zoo

__all__ = ['FileDataBase', 'decompose_model_key', 'EnsembleEngine',
           'HostedModel', 'Zoo']
