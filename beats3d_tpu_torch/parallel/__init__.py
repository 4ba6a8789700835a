"""Multi-device paths on ``torch.distributed`` (counterpart of
beats3d_tpu/parallel): a (data, model) mesh of ranks, tree-sharded forest
evaluation and the sharded training steps.  :mod:`.launch` starts the
ranks; ``python -m beats3d_tpu_torch.parallel --ranks N --device cuda|cpu``
runs the multi-rank dry run (:mod:`.dryrun`)."""

from .eval_sharded import evaluate_forest_sharded
from .mesh import Mesh, make_mesh
from .train_sharded import sharded_histogram_step, sharded_train_step

__all__ = [
    "Mesh",
    "make_mesh",
    "evaluate_forest_sharded",
    "sharded_histogram_step",
    "sharded_train_step",
]
