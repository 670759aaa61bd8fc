"""Distributed Word2Vec: data-parallel SGNS over the logical mesh.

Counterpart of ``deeplearning4j_tpu/nlp/distributed_w2v.py`` on the port's
logical mesh (``parallel/mesh.py``: ``shard_map``, ``all_gather``,
``psum``). Each worker takes its shard of the (center, context, negatives)
batch, padded to a multiple of the workers with ``valid`` masking the
padding, computes its rows' sparse updates, and the updates are gathered
in worker order and scatter-added into the tables. A logical mesh holds
one copy of the replicated tables, so the gathered updates are added once.
CBOW keeps the single-device step, as in the reference. The default mesh
is ``make_mesh()`` on the model's device: one worker (the reference's is
every local device).

Reference: deeplearning4j-scaleout spark/dl4j-spark-nlp{-java8} —
SparkWord2Vec/SparkSequenceVectors partition the corpus across executors,
each trains locally, and the Spark application merges
(TextPipeline.java:47 builds the vocab with Spark accumulators).
"""
from __future__ import annotations

import torch

from ..parallel import mesh as meshlib
from .sequence_vectors import SequenceVectors, _sgns_grads


class DistributedWord2Vec(SequenceVectors):
    """SequenceVectors with the SGNS step sharded over a 1-D 'data' mesh.

    API-identical to Word2Vec/SequenceVectors; pass a mesh (default: one
    worker on the model's device). Each step pads the pair batch to a
    multiple of the mesh size, shards it, computes per-shard sparse
    gradients, gathers them in worker order and scatter-adds them into the
    replicated tables.
    """

    def __init__(self, *, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self._mesh = mesh

    def _build_step(self):
        if self.learning_algorithm == "cbow":
            # CBOW keeps the single-device step (reference Spark path is
            # skip-gram)
            return super()._build_step()
        mesh = self._mesh if self._mesh is not None else \
            meshlib.make_mesh(device=self._device())
        n = meshlib.axis_size(mesh, "data")
        self._n_devices = n
        rep, dsh = (), ("data",)

        def step(syn0, syn1, centers, contexts, negs, lr, ctx_mask=None):
            B, D = centers.shape[0], syn0.shape[1]
            pad = (-B) % n
            if pad:
                centers = torch.cat([centers, centers.new_zeros(pad)])
                contexts = torch.cat([contexts, contexts.new_zeros(pad)])
                negs = torch.cat([negs, negs.new_zeros((pad, negs.shape[1]))])
            valid = (torch.arange(B + pad, device=syn0.device) < B
                     ).to(syn0.dtype)

            def worker(centers, contexts, negs, valid):
                # per-worker rows [n, B/n, ...]; the tables are replicated.
                # The SPARSE row updates are all-gathered (traffic O(B*D),
                # never a dense [V,D] buffer)
                grad_v, g_upos, g_uneg, loss_row = _sgns_grads(
                    syn0[centers], syn1[contexts], syn1[negs])
                w = valid[..., None]         # padded rows contribute nothing
                loss = meshlib.psum((loss_row * valid).sum(-1), mesh, "data")

                def gather(t):
                    return meshlib.all_gather(t, mesh, "data")
                return (gather(centers), gather(-lr * grad_v * w),
                        gather(contexts), gather(-lr * g_upos * w),
                        gather(negs), gather(-lr * g_uneg * w[..., None]),
                        loss)

            ac, agv, act, agp, an, agn, loss = meshlib.shard_map(
                worker, mesh=mesh, in_specs=(dsh, dsh, dsh, dsh),
                out_specs=(rep,) * 7)(centers, contexts, negs, valid)
            # every worker's updates, in worker order, into the one copy
            syn0.index_add_(0, ac.reshape(-1), agv.reshape(-1, D))
            syn1.index_add_(0, act.reshape(-1), agp.reshape(-1, D))
            syn1.index_add_(0, an.reshape(-1), agn.reshape(-1, D))
            return syn0, syn1, loss / B    # mean pair loss, like single-device

        return step
