"""Clustering and nearest neighbours: k-means and exact t-SNE on the
device, the trees, Barnes-Hut t-SNE and the kNN server on the host.

Counterpart of ``deeplearning4j_tpu/clustering/__init__.py``: the same
exports, name for name.
"""
from .kmeans import KMeansClustering
from .trees import KDTree, QuadTree, SpTree
from .tsne import BarnesHutTsne, Tsne
from .vptree import VPTree

__all__ = ["BarnesHutTsne", "KDTree", "KMeansClustering", "QuadTree",
           "SpTree", "Tsne", "VPTree"]
