"""Minimal inference demos on raw data (scripts/examples/): sequential KITTI
odometry and pairwise ModelNet40, through ``ModelInferenceHelper``."""
