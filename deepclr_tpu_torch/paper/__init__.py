"""The paper's tables and figures from inference output (``scripts/paper``):
each module runs as ``python -m deepclr_tpu_torch.paper.<name> PATH`` over
the run directories that ``python -m deepclr_tpu_torch.inference`` and
``.icp`` write under PATH, with its script's arguments, warnings and output:

* ``kitti_odometry_table``: per-sequence t/r RMSE and the mean time of
  scenario ``kitti_04_10``, method ``DEEPCLR``;
* ``kitti_artificial_table``: one row a method of scenario ``kitti_pairs``;
* ``modelnet40_table``: one row a method of scenario ``modelnet40_unseen``
  on dataset ``test_unseen_0.04``;
* ``modelnet40_plots``: error-against-noise curves of ``modelnet40_unseen``
  (PNG and PDF, matplotlib);
* ``cloud_figures``: one frame's template and source before and after the
  predicted transform (PNG, matplotlib).

The tables print ``pandas.DataFrame(data).transpose()`` where pandas
imports, and the same rows and numbers in a standard-library table where it
does not; the figures need matplotlib and exit with a message without it."""
