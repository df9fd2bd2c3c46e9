"""Data parallelism over several devices (counterpart of
birefnet_tpu/parallel/).

The JAX package runs one program over a (data, spatial) mesh of TPU chips
and lets XLA insert the collectives. The port splits that in PyTorch's
idiom: serving is one process driving every card of the mesh (a batch split
over the data axis, one captured graph per card, no collective:
sharding.make_sharded_infer_fn), and training is one process per card in a
torch.distributed group (ranks.spawn), each rank on its share of the batch,
with one all-reduce of the gradients per step (train.make_train_step's
process_group). The spatial axis is not ported (mesh.SPATIAL_CUT).
"""

from . import mesh, ranks, sharding

__all__ = ["mesh", "ranks", "sharding"]
