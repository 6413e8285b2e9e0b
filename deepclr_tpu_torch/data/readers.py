"""Raw dataset readers (KITTI odometry, ModelNet40), numpy only: the JAX
package's ``data/readers.py``, the same records in the same (shuffled)
order for the same seed.  The dataset converters read raw data through it.

A direct reader of the KITTI odometry layout (no pykitti):
  base_path/sequences/{seq}/velodyne/*.bin   float32 x,y,z,reflectance
  base_path/sequences/{seq}/times.txt        seconds per frame
  base_path/sequences/{seq}/calib.txt        'Tr:' = T_cam0_velo (3x4)
  base_path/poses/{seq}.txt                  cam0 poses, 12 cols

Poses are converted to the velodyne frame with cam2velo, as the reference
DeepCLR's KITTI dataset does.
"""
from __future__ import annotations

import glob
import os.path as osp
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = [
    "cam2velo",
    "velo2cam",
    "KittiOdometrySequence",
    "KittiOdometryVelodyneData",
    "KittiSamplePairData",
    "ModelNet40PointClouds",
]


def cam2velo(p: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Camera-frame pose -> velodyne-frame pose using calibration v."""
    return np.linalg.inv(v) @ p @ v


def velo2cam(p: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Velodyne-frame pose -> camera-frame pose using calibration v."""
    return v @ p @ np.linalg.inv(v)


class KittiOdometrySequence:
    """Low-level access to one KITTI odometry sequence."""

    def __init__(self, base_path: str, sequence: str):
        self.base_path = base_path
        self.sequence = sequence
        seq_dir = osp.join(base_path, "sequences", sequence)
        self._velo_files = sorted(glob.glob(osp.join(seq_dir, "velodyne", "*.bin")))
        if not self._velo_files:
            raise FileNotFoundError(f"No velodyne scans under {seq_dir}")

        times_file = osp.join(seq_dir, "times.txt")
        self.timestamps = (
            np.loadtxt(times_file) if osp.exists(times_file)
            else np.arange(len(self._velo_files), dtype=float) * 0.1
        )

        self.T_cam0_velo = self._read_calib(osp.join(seq_dir, "calib.txt"))

        poses_file = osp.join(base_path, "poses", f"{sequence}.txt")
        if osp.exists(poses_file):
            raw = np.atleast_2d(np.loadtxt(poses_file))
            self.poses = [self._vec_to_mat(r) for r in raw]
        else:
            self.poses = []

    @staticmethod
    def _vec_to_mat(v: np.ndarray) -> np.ndarray:
        m = np.eye(4)
        m[:3, :] = v.reshape(3, 4)
        return m

    @staticmethod
    def _read_calib(path: str) -> np.ndarray:
        tr = np.eye(4)
        if osp.exists(path):
            with open(path) as f:
                for line in f:
                    if line.startswith("Tr"):
                        vals = np.array(line.split(":", 1)[1].split(), float)
                        tr[:3, :] = vals.reshape(3, 4)
                        break
        return tr

    def __len__(self) -> int:
        return len(self._velo_files)

    def get_velo(self, idx: int) -> np.ndarray:
        """(N, 4) float32 cloud: x, y, z, reflectance."""
        return np.fromfile(self._velo_files[idx], dtype=np.float32).reshape(-1, 4)

    def get_pose_velo(self, idx: int) -> np.ndarray:
        """Velodyne-frame pose (identity when no ground truth shipped)."""
        if not self.poses:
            return np.eye(4)
        return cam2velo(self.poses[idx], self.T_cam0_velo)


class KittiOdometryVelodyneData:
    """Per-frame records {idx, timestamp [us], pose, cloud}."""

    def __init__(self, base_path: str, sequence: str, shuffle: bool = False,
                 seed: int = 0):
        self.data = KittiOdometrySequence(base_path, sequence)
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.data)

    def __iter__(self) -> Iterator[Dict]:
        idxs = list(range(len(self.data)))
        if self.shuffle:
            self._rng.shuffle(idxs)
        for k in idxs:
            yield {
                "idx": k,
                "timestamp": float(self.data.timestamps[k]) * 1e6,  # microseconds
                "pose": self.data.get_pose_velo(k),
                "cloud": self.data.get_velo(k),
            }


class KittiSamplePairData:
    """DeepVCP-protocol pairs: anchors every ``frame_interval`` frames, paired
    with all following frames within ``max_distance`` meters."""

    def __init__(self, base_path: str, sequence: str, frame_interval: int,
                 max_distance: float, shuffle: bool = False, seed: int = 0):
        self.data = KittiOdometrySequence(base_path, sequence)
        self.pairs = self._find_pairs(frame_interval, max_distance)
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def _find_pairs(self, frame_interval: int, max_distance: float) -> List[Tuple[int, int]]:
        pairs = []
        n = len(self.data)
        for i in range(0, n, frame_interval):
            pose0 = self.data.get_pose_velo(i)
            for j in range(i + 1, n):
                pose1 = self.data.get_pose_velo(j)
                if np.linalg.norm(pose0[:3, 3] - pose1[:3, 3]) >= max_distance:
                    break
                pairs.append((i, j))
        return pairs

    def __len__(self) -> int:
        return len(self.pairs)

    def __iter__(self) -> Iterator[List[Dict]]:
        idxs = list(range(len(self.pairs)))
        if self.shuffle:
            self._rng.shuffle(idxs)
        for k in idxs:
            i, j = self.pairs[k]
            yield [
                {
                    "idx": i,
                    "timestamp": float(self.data.timestamps[i]) * 1e6,
                    "pose": self.data.get_pose_velo(i),
                    "cloud": self.data.get_velo(i),
                },
                {
                    "idx": j,
                    "timestamp": float(self.data.timestamps[j]) * 1e6,
                    "pose": self.data.get_pose_velo(j),
                    "cloud": self.data.get_velo(j),
                },
            ]


class ModelNet40PointClouds:
    """PointNet++-preprocessed ModelNet40 txt clouds (xyz + normals, 6 cols).

    ``filename`` is a split list file; each line 'shape_0001' maps to
    '{dir}/{shape}/{shape_0001}.txt'.
    """

    def __init__(self, filename: str, shape_list: Optional[List[str]] = None,
                 shuffle: bool = False, seed: int = 0):
        with open(filename) as f:
            names = [line.rstrip("\n") for line in f]
        directory = osp.dirname(filename)
        self.data = [
            osp.join(directory, name.rpartition("_")[0], f"{name}.txt")
            for name in names
            if shape_list is None or name.rpartition("_")[0] in shape_list
        ]
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.data)

    def __iter__(self) -> Iterator[Dict]:
        idxs = list(range(len(self.data)))
        if self.shuffle:
            self._rng.shuffle(idxs)
        for k in idxs:
            cloud = np.loadtxt(self.data[k], delimiter=",")
            yield {"idx": k, "cloud": cloud}
