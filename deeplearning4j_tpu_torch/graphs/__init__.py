"""Graph embeddings: the adjacency-list graph, its random walks, DeepWalk
and node2vec.

Counterpart of ``deeplearning4j_tpu/graphs/__init__.py``: the same
exports, name for name.
"""
from .deepwalk import DeepWalk
from .graph import Graph, RandomWalkIterator, WeightedRandomWalkIterator
from .node2vec import Node2Vec, Node2VecWalkIterator

__all__ = ["DeepWalk", "Graph", "Node2Vec", "Node2VecWalkIterator",
           "RandomWalkIterator", "WeightedRandomWalkIterator"]
