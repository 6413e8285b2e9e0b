"""Data viewers (``scripts/visualization``), each run as ``python -m
deepclr_tpu_torch.visualization.<name>`` with its script's arguments and
output files, on matplotlib (the port's ``utils.pcv.PointCloudVisualizer``):

* ``show_kitti_odometry``: a raw KITTI odometry sequence, every 100th
  cloud, then the driven path;
* ``show_modelnet40``: raw ModelNet40 clouds, every 10th;
* ``view_dataflow``: samples of a ``.pack`` dataflow;
* ``view_loader_output``: training batches of a YAML's data loader, with
  the deferred augmentations applied as the model applies them;
* ``view_scheduler``: the learning-rate schedule of a YAML.

Each shows a window, or writes files for a headless run (``--save-dir``,
``--save`` or ``--output``), and exits with a message that names matplotlib
where it does not import."""
