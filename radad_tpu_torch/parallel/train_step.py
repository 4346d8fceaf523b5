"""The data-parallel train step: a batch split over 'data', the DB rows
over 'index'.

Counterpart: ``radad_tpu/parallel/train_step.py``
(``make_parallel_train_step``). The update rule is not written again: the
step wraps the pipeline's ``make_step_fns`` (``train/pipeline.py``) behind
the encoder embed, with the sharded retrieve injected, as JAX does. JAX's
step is one jitted program whose gradients GSPMD sums over 'data'; here
each rank steps on its slice and ``make_step_fns(mesh=...)`` makes the step
the global batch's: the loss divided by the global valid count, BatchNorm's
statistics over the global batch, the gradients summed over 'data' before
the per-group clip and Adam (every rank applies the same update), global
metrics.

Dropout draws from the ``generator`` the caller passes, a generator a
rank, so its masks differ from JAX's (which draws from one key over the
global batch); parity runs take dropout 0.
"""

from __future__ import annotations

from radad_tpu_torch.parallel.mesh import Mesh
from radad_tpu_torch.parallel.sharded_index import sharded_retrieve


def make_parallel_train_step(model, encoder, config, opt, mesh: Mesh,
                             metric: str = "L2"):
    """→ ``step(index_args, audio, batch_labels, exclude_ids, valid,
    pos_weight, generator=None)`` → metrics (``loss``, ``acc``,
    ``grad_norm_projection``, ``grad_norm_fuse``, ``grad_norm_detection``:
    the global batch's), updating ``model`` and ``opt`` in place.
    ``index_args = (vectors, labels, ids, row_valid)`` is this rank's row
    block; ``audio``, ``batch_labels``, ``exclude_ids`` and ``valid`` its
    slice of the batch."""
    # the pipeline imports parallel/: its step core is imported here
    from radad_tpu_torch.train.pipeline import (make_embed_fn,
                                                make_step_fns,
                                                new_accumulators)

    embed = make_embed_fn(encoder, config)
    index = {}

    def retrieve(tpp, exclude_ids):
        vectors, labels, ids, row_valid = index["args"]
        return sharded_retrieve(mesh, tpp, vectors, labels, ids, row_valid,
                                exclude_ids, k=config.top_k, metric=metric)

    steps = make_step_fns(
        model, opt, retrieve,
        grad_checkpoint=config.use_gradient_checkpointing,
        # every step knob the pipeline honors: one dropped here would make
        # the two steps drift though they share make_step_fns
        ablate_retrieval=config.ablate_retrieval,
        ablate_query=config.ablate_query, mesh=mesh)

    def step(index_args, audio, batch_labels, exclude_ids, valid,
             pos_weight, generator=None):
        index["args"] = index_args
        tpp = embed(audio).clone()  # not an inference tensor
        bm = steps.train_step(new_accumulators(tpp.device), tpp,
                              batch_labels, exclude_ids, valid, pos_weight,
                              generator)
        return {"loss": bm["loss"], "acc": bm["acc"],
                "grad_norm_projection": bm["gn_proj"],
                "grad_norm_fuse": bm["gn_fuse"],
                "grad_norm_detection": bm["gn_det"]}

    return step
