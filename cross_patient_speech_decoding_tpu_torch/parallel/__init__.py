"""Multi-device parallelism of the port: one process per device under
``torch.distributed``, the sharding helpers, the data-parallel train steps
and the launcher that starts the ranks."""

from cross_patient_speech_decoding_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    launch,
    make_mesh,
    make_padded_sharded_ctc_train_step,
    make_sharded_classifier_train_step,
    make_sharded_ctc_train_step,
    replicated,
    shard_batch,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "launch",
    "make_mesh",
    "make_padded_sharded_ctc_train_step",
    "make_sharded_classifier_train_step",
    "make_sharded_ctc_train_step",
    "replicated",
    "shard_batch",
]
