"""Inference: the model databases (local, and the remote registry) and the
zoo, hosted models, the fused sliding-window ensemble engine and its
micro-batcher, the per-model engine, and the host runtime (async runner,
pipelined directory mode)."""

from .batching import DynamicBatcher
from .database import FileDataBase, URLDataBase, decompose_model_key
from .engine import InferenceEngine
from .ensemble_engine import EnsembleEngine
from .model import HostedModel
from .pipeline import ScanPipeline
from .runner import AsyncRunner
from .zoo import Zoo

__all__ = ['AsyncRunner', 'DynamicBatcher', 'FileDataBase', 'URLDataBase',
           'decompose_model_key', 'EnsembleEngine', 'HostedModel',
           'InferenceEngine', 'ScanPipeline', 'Zoo']
