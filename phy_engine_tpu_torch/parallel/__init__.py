from .batch import batched_op, batched_transient, batch_params, batch_state
from .mesh import make_mesh, sharded_batched_transient

__all__ = ["batched_op", "batched_transient", "batch_params",
           "batch_state", "make_mesh", "sharded_batched_transient"]
