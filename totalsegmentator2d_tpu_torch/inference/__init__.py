"""Inference: the local model database and zoo, hosted models, the fused
sliding-window ensemble engine and the per-model engine."""

from .database import FileDataBase, decompose_model_key
from .engine import InferenceEngine
from .ensemble_engine import EnsembleEngine
from .model import HostedModel
from .zoo import Zoo

__all__ = ['FileDataBase', 'decompose_model_key', 'EnsembleEngine',
           'HostedModel', 'InferenceEngine', 'Zoo']
