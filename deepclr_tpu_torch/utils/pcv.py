"""Point cloud visualization (the JAX package's ``utils/pcv.py``).

API-compatible replacement for the reference DeepCLR's VTK-based viewer:
add/update named clouds with colors, optional ground plane, and render.
Backend is matplotlib 3D, imported when a visualizer is made, so the module
imports without it; ``spin`` shows an interactive window when a display is
available, ``save`` renders to file for headless use.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["PointCloudVisualizer"]


class PointCloudVisualizer:
    """Simple multi-cloud 3D viewer."""

    def __init__(self, background: Tuple[float, float, float] = (1, 1, 1),
                 point_size: float = 1.0):
        import matplotlib.pyplot as plt

        self._plt = plt
        self._fig = plt.figure(figsize=(10, 8))
        self._ax = self._fig.add_subplot(111, projection="3d")
        self._fig.patch.set_facecolor(background)
        self._point_size = point_size
        self._clouds: Dict[str, dict] = {}
        self._ground_plane = None

    def add_cloud(self, name: str, points: np.ndarray,
                  color=None, point_size: Optional[float] = None) -> None:
        """Add or replace a named cloud ((N,3+) array).  ``color`` is one
        RGB triple or an (N,3) per-point array."""
        color = None if color is None else np.asarray(color, np.float32)
        self._clouds[name] = {
            "points": np.asarray(points)[:, :3],
            "color": color,
            "size": point_size or self._point_size,
        }

    def update_cloud(self, name: str, points: np.ndarray) -> None:
        if name not in self._clouds:
            raise KeyError(name)
        self._clouds[name]["points"] = np.asarray(points)[:, :3]

    def remove_cloud(self, name: str) -> None:
        self._clouds.pop(name, None)

    def add_ground_plane(self, z: float = 0.0, size: float = 50.0) -> None:
        self._ground_plane = (z, size)

    def set_camera(self, elev: float = 30.0, azim: float = -60.0) -> None:
        self._ax.view_init(elev=elev, azim=azim)

    # -- the reference viewer's API ----------------------------------------

    def set_window_size(self, x: int, y: int) -> None:
        dpi = self._fig.get_dpi()
        self._fig.set_size_inches(x / dpi, y / dpi)

    def set_background(self, r: float, g: float, b: float) -> None:
        self._fig.patch.set_facecolor((r, g, b))
        self._ax.set_facecolor((r, g, b))

    def add_point_cloud(self, identifier: str, cloud: np.ndarray,
                        color=None, point_size: Optional[float] = None,
                        **_style) -> None:
        self.add_cloud(identifier, cloud, color=color, point_size=point_size)

    def update_point_cloud(self, identifier: str, cloud=None, color=None,
                           size: Optional[float] = None, **_style) -> None:
        """Add-or-update, like the reference viewer."""
        if identifier not in self._clouds:
            self.add_cloud(identifier, cloud, color=color, point_size=size)
            return
        entry = self._clouds[identifier]
        if cloud is not None:
            entry["points"] = np.asarray(cloud)[:, :3]
        if color is not None:
            entry["color"] = np.asarray(color, np.float32)
        if size is not None:
            entry["size"] = size

    def remove_point_cloud(self, identifier: str) -> None:
        self.remove_cloud(identifier)

    def remove_all_point_clouds(self) -> None:
        self._clouds.clear()

    def show_axes_marker(self, show: bool) -> None:
        self._ax.set_axis_on() if show else self._ax.set_axis_off()

    def set_ground_plane(self, show: bool, length: float = 5.0,
                         cell_size: float = 1.0, color=None,
                         alpha: Optional[float] = None) -> None:
        self._ground_plane = (0.0, length) if show else None

    def get_camera_params(self) -> Dict:
        return {"elev": self._ax.elev, "azim": self._ax.azim}

    def set_camera_params(self, position=None, focal_point=None,
                          view_up=None, **kwargs) -> None:
        """Best-effort mapping of the VTK camera onto matplotlib view
        angles (elev/azim from the position->focal-point direction)."""
        if "elev" in kwargs or "azim" in kwargs:
            self._ax.view_init(elev=kwargs.get("elev", self._ax.elev),
                               azim=kwargs.get("azim", self._ax.azim))
            return
        if position is not None:
            fp = np.zeros(3) if focal_point is None else np.asarray(focal_point)
            d = np.asarray(position, np.float64) - fp
            r = np.linalg.norm(d) + 1e-12
            self._ax.view_init(
                elev=float(np.degrees(np.arcsin(d[2] / r))),
                azim=float(np.degrees(np.arctan2(d[1], d[0]))),
            )

    def _render(self) -> None:
        self._ax.clear()
        for name, c in self._clouds.items():
            pts = c["points"]
            color = c["color"]
            if color is None:
                kw = {}
            elif color.ndim == 1:
                kw = {"c": [color]}
            else:  # per-point colors
                kw = {"c": color}
            self._ax.scatter(
                pts[:, 0], pts[:, 1], pts[:, 2],
                s=c["size"], label=name, depthshade=False, **kw,
            )
        if self._ground_plane is not None:
            z, size = self._ground_plane
            xx, yy = np.meshgrid(
                np.linspace(-size, size, 2), np.linspace(-size, size, 2)
            )
            self._ax.plot_surface(xx, yy, np.full_like(xx, z), alpha=0.1)
        self._ax.set_xlabel("x [m]")
        self._ax.set_ylabel("y [m]")
        self._ax.set_zlabel("z [m]")
        if self._clouds:
            self._ax.legend()

    def spin_once(self, t: float = 10.0, force_redraw: bool = True) -> None:
        """Render one frame and wait ``t`` milliseconds (reference
        signature; interactive backends only)."""
        if force_redraw:
            self._render()
        self._plt.pause(max(t, 1.0) / 1000.0)

    def spin(self) -> None:
        """Render and block until the window is closed."""
        self._render()
        self._plt.show()

    def save(self, filename: str) -> None:
        """Headless rendering to an image file."""
        self._render()
        self._fig.savefig(filename, bbox_inches="tight")

    def close(self) -> None:
        self._plt.close(self._fig)
