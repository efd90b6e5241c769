"""Multi-process scaling of the object bank (counterpart of
``vmap_tpu/parallel/``).

A device of the JAX package's ``("obj", "data")`` mesh is a process, a
rank, here: one rank per device is PyTorch's idiom, so ``tpu.mesh_axes =
{"obj": n_obj, "data": n_data}`` runs as ``n_obj * n_data`` ranks. The
object bank, its Adam state, the keyframe tables and the object ids split
by contiguous rows over ``obj`` (objects are independent: the only
traffic a frame is one loss scalar); the frame pool and the background
bank are replicated, and every rank trains the whole background, as the
JAX package's fused sharded step does ("data" is replication there too).

``distributed``: the process group (``init_from_env``), the primary rank,
the rank's device and the gathers of a sharded bank. ``sharding``: the
mesh's shape, a rank's place in it and the row slicing of the state.
``launch``: a world's ranks started as processes on one machine, and a
trainer rank that reports itself.
"""
