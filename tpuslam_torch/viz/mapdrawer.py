"""Map rendering, the MapDrawer analogue (port of
``tpuslam/viz/mapdrawer.py``; reference MapDrawer.cc:326-657: map points,
keyframe frusta, the covisibility graph, cuboid wireframes, plane patches
and the ground-truth trajectory in a Pangolin window).  A host function
MapState -> matplotlib 3D axis or PNG, for headless runs and the apps'
``--viz-every`` dumps.  The map's tensors are read to the host first;
``matplotlib`` is imported when called.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from .framedrawer import host

# cuboid corners in the object frame for a unit pose with half-scale s
_CORNER_SIGNS = np.array([[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
                          [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float32)
_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
_FIELDS = ("pt_valid", "pt_pos", "kf_valid", "kf_pose", "cub_valid", "cub_pose", "cub_scale", "plane_valid",
           "plane_coef")


def _frustum_pts(T_cw, scale=0.1):
    """Camera frustum line segments in the world frame (MapDrawer::DrawKeyFrames)."""
    T_wc = np.linalg.inv(np.asarray(T_cw))
    w, h, z = 0.8 * scale, 0.5 * scale, scale
    pts_c = np.array([[0, 0, 0], [w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]], np.float32)
    pts_w = (T_wc[:3, :3] @ pts_c.T).T + T_wc[:3, 3]
    segs = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts_w[a], pts_w[b]) for a, b in segs]


def draw_map(m, n_kf: int = 0, ax=None, gt_traj=None, show_points=True, show_keyframes=True, show_cuboids=True,
             show_planes=True, show_covisibility=False, point_size: float = 0.5):
    """Render a MapState onto a matplotlib 3D axis and return the axis.
    The ``show_*`` keywords are the Viewer's menu toggles (Viewer.cc:68-80)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

        fig = plt.figure(figsize=(9, 7))
        ax = fig.add_subplot(111, projection="3d")

    h = SimpleNamespace(**{k: host(getattr(m, k)) for k in _FIELDS})
    pt_valid = h.pt_valid.astype(bool)
    lim = None
    if pt_valid.any():
        P_all = h.pt_pos[pt_valid]
        # robust axis bounds: a handful of outlier points must not blow up
        # the view (the GL viewer auto-navigates; matplotlib needs limits)
        lo = np.percentile(P_all, 2, axis=0)
        hi = np.percentile(P_all, 98, axis=0)
        pad = 0.2 * max(float((hi - lo).max()), 1.0)
        lim = (lo - pad, hi + pad)
    if show_points and pt_valid.any():
        P = P_all[np.all((P_all >= lim[0]) & (P_all <= lim[1]), axis=1)]
        ax.scatter(P[:, 0], P[:, 1], P[:, 2], s=point_size, c="k", alpha=0.4)

    kf_valid = h.kf_valid.astype(bool)
    kf_ids = np.where(kf_valid)[0] if n_kf <= 0 else np.arange(min(n_kf, kf_valid.shape[0]))
    if show_keyframes:
        centers = []
        for k in kf_ids:
            if not kf_valid[k]:
                continue
            for a, b in _frustum_pts(h.kf_pose[k]):
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], c="b", lw=0.5)
            centers.append(np.linalg.inv(h.kf_pose[k])[:3, 3])
        if centers:
            C = np.stack(centers)
            ax.plot(C[:, 0], C[:, 1], C[:, 2], c="g", lw=1.0, label="keyframes")

    if show_covisibility and len(kf_ids) > 1:
        from ..map import mapstate as ms

        cov = host(ms.covisibility(m))
        centers = {int(k): np.linalg.inv(h.kf_pose[k])[:3, 3] for k in kf_ids if kf_valid[k]}
        for i in centers:
            for j in centers:
                if j > i and cov[i, j] >= 15:
                    a, b = centers[i], centers[j]
                    ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], c="c", lw=0.3, alpha=0.5)

    if show_cuboids:
        for c in np.where(h.cub_valid.astype(bool))[0]:
            T_ow, s = h.cub_pose[c], h.cub_scale[c]
            corners = (T_ow[:3, :3] @ (_CORNER_SIGNS * s).T).T + T_ow[:3, 3]
            for a, b in _BOX_EDGES:
                ax.plot([corners[a, 0], corners[b, 0]], [corners[a, 1], corners[b, 1]],
                        [corners[a, 2], corners[b, 2]], c="r", lw=1.0)

    if show_planes:
        for q in np.where(h.plane_valid.astype(bool))[0]:
            n, d = h.plane_coef[q][:3], h.plane_coef[q][3]
            nn = n / max(np.linalg.norm(n), 1e-9)
            # a 1 m quad centred at the plane's closest point to the origin
            c0 = -d * nn
            t1 = np.cross(nn, [0, 0, 1.0])
            if np.linalg.norm(t1) < 1e-3:
                t1 = np.cross(nn, [0, 1.0, 0])
            t1 /= np.linalg.norm(t1)
            t2 = np.cross(nn, t1)
            quad = np.stack([c0 + a * t1 + b * t2 for a, b in
                             [(-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5)]])
            ax.plot(quad[:, 0], quad[:, 1], quad[:, 2], c="m", lw=1.0, alpha=0.8)

    if gt_traj is not None:
        G = np.stack([np.linalg.inv(host(T))[:3, 3] for T in gt_traj])
        ax.plot(G[:, 0], G[:, 1], G[:, 2], c="orange", lw=1.0, ls="--", label="GT")

    ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
    if lim is not None:
        ax.set_xlim(lim[0][0], lim[1][0])
        ax.set_ylim(lim[0][1], lim[1][1])
        ax.set_zlim(lim[0][2], lim[1][2])
    return ax


def save_map_png(path: str, m, n_kf: int = 0, **kw):
    """Render the map to a PNG (a headless Viewer snapshot)."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    ax = draw_map(m, n_kf=n_kf, **kw)
    ax.figure.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(ax.figure)
    return path
