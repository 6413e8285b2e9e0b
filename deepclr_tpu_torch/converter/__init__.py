"""Dataset converters: raw KITTI odometry and ModelNet40 files, and
reference LMDB datasets, into the ``.pack`` stores the port trains and
scores on.  Each module runs as ``python -m deepclr_tpu_torch.converter.<name>``
with the JAX package's script contract (``KITTI_PATH``, ``MODELNET40_PATH``)
and writes the same files byte for byte; none of them needs jax or a card."""
