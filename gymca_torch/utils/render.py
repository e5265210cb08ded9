"""Host-side matplotlib renders for all envs.

Counterpart of ``gymca_tpu/utils/render.py``, figure for figure:
Helicopter: one grid and the agent marker; Bulldozer and Advanced: four
panels (local window, global grid with fire-seed and agent markers, time
gauge, forest-versus-burned counts); Advanced adds the day/night palettes,
the dousing overlay and a wind arrow; ``plot_grid_attribute`` draws the
terrain heatmaps.  Vehicle markers are vector Paths, so no asset files.

Tensors come to the host once per call.  matplotlib is imported inside the
functions, so importing this module pulls nothing in.
"""

from __future__ import annotations

import numpy as np
import torch

from gymca_torch.core.env import tree_map

__all__ = [
    "clear_ax",
    "get_norm_cmap",
    "plot_grid",
    "local_window",
    "figure_to_rgb",
    "render_helicopter",
    "render_bulldozer",
    "render_advanced",
    "plot_grid_attribute",
]

# Day palette (hex values shared with the reference gallery look)
COLOR_EMPTY = "#DDD1D3"  # gray
COLOR_TREE = "#A9C499"  # green
COLOR_FIRE = "#E68181"  # salmon red
COLOR_GAUGE = "#D4CCDB"  # gray-purple
# Night palette
COLOR_EMPTY_NIGHT = "#696969"
COLOR_TREE_NIGHT = "#2F4F4F"
COLOR_FIRE_NIGHT = "#8B0000"
COLOR_GAUGE_NIGHT = "#483D8B"

FIGSIZE = (15, 12)
FIGSTYLE = "seaborn-v0_8-whitegrid"
N_LOCAL = 3  # local window radius -> (2*3+1)^2 view


def _host(tree):
    """Tensors of a tree as numpy arrays, each copied to the host once."""
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                    else x, tree)


def clear_ax(ax, xticks: bool = True, yticks: bool = True):
    """Strip spines/labels so only the data shows."""
    ax.grid(False)
    if xticks:
        ax.set_xticklabels([])
    if yticks:
        ax.set_yticklabels([])
    for side in ("right", "top", "left", "bottom"):
        ax.spines[side].set_visible(False)


def get_norm_cmap(values, colors):
    """BoundaryNorm/ListedColormap for ascending cell values."""
    from matplotlib.colors import BoundaryNorm, ListedColormap

    norm = BoundaryNorm(values, len(values), extend="max")
    cmap = ListedColormap(colors)
    return norm, cmap


def plot_grid(ax, grid, **imshow_kwargs):
    """imshow with minor-tick cell gridlines (reference plot_grid look)."""
    nrows, ncols = grid.shape[:2]
    ax.set_xticks(np.arange(0, ncols, 1))
    ax.set_yticks(np.arange(0, nrows, 1))
    ax.set_xticks(np.arange(-0.5, ncols, 1), minor=True)
    ax.set_yticks(np.arange(-0.5, nrows, 1), minor=True)
    if max(nrows, ncols) <= 64:  # gridlines unreadable beyond this
        ax.grid(which="minor", color="whitesmoke", linestyle="-", linewidth=2)
    ax.grid(which="major", linewidth=0)
    ax.tick_params(axis="both", which="both", length=0)
    clear_ax(ax)
    return ax.imshow(grid, **imshow_kwargs)


def local_window(grid: np.ndarray, pos, radius: int, fill) -> np.ndarray:
    """Radius-n Moore window around ``pos``, out-of-bounds filled: pad, then
    slice (on the host; ``gymca_torch.utils.neighbors.moore_n`` is the tensor
    form)."""
    grid = np.asarray(grid)
    r, c = int(pos[0]), int(pos[1])
    pad = [(radius, radius), (radius, radius)] + [(0, 0)] * (grid.ndim - 2)
    padded = np.pad(grid, pad, constant_values=fill)
    return padded[r : r + 2 * radius + 1, c : c + 2 * radius + 1]


def figure_to_rgb(fig) -> np.ndarray:
    """Rasterize a matplotlib Figure to an (H, W, 3) uint8 array."""
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def _title(env) -> str:
    spec = getattr(env, "spec", None)
    if spec is not None and getattr(spec, "id", None):
        return spec.id
    return getattr(env, "title", type(env).__name__)


# --------------------------------------------------------------------------- #
# Vector vehicle markers: polygon silhouettes built as matplotlib Paths, the
# JAX package's shapes point for point.
# --------------------------------------------------------------------------- #


def _multi_polygon_path(parts):
    from matplotlib.path import Path

    verts, codes = [], []
    for poly in parts:
        verts.extend(list(poly) + [poly[0]])
        codes.extend(
            [Path.MOVETO] + [Path.LINETO] * (len(poly) - 1) + [Path.CLOSEPOLY]
        )
    return Path(verts, codes)


def helicopter_marker():
    """Top-view helicopter: fuselage, tail boom, tail rotor, two main-rotor
    blades."""
    return _multi_polygon_path([
        [(-0.35, 0.0), (-0.2, 0.28), (0.15, 0.32), (0.38, 0.12),
         (0.38, -0.12), (0.15, -0.32), (-0.2, -0.28)],
        [(-0.85, 0.06), (-0.3, 0.1), (-0.3, -0.1), (-0.85, -0.06)],
        [(-0.95, 0.22), (-0.82, 0.22), (-0.82, -0.22), (-0.95, -0.22)],
        [(-0.55, 0.62), (0.62, -0.5), (0.52, -0.62), (-0.65, 0.52)],
        [(0.52, 0.62), (0.62, 0.5), (-0.55, -0.62), (-0.65, -0.52)],
    ])


def bulldozer_marker():
    """Side-view bulldozer: tracks, cab, exhaust stack, push arm, blade."""
    return _multi_polygon_path([
        [(-0.55, -0.6), (0.45, -0.6), (0.45, -0.15), (-0.55, -0.15)],
        [(-0.45, -0.15), (0.1, -0.15), (0.1, 0.45), (-0.2, 0.45),
         (-0.45, 0.2)],
        [(-0.05, 0.45), (0.03, 0.45), (0.03, 0.7), (-0.05, 0.7)],
        [(0.1, -0.2), (0.58, -0.1), (0.58, -0.25), (0.1, -0.35)],
        [(0.55, -0.65), (0.72, -0.65), (0.72, 0.3), (0.55, 0.3)],
    ])


# --------------------------------------------------------------------------- #
# Helicopter: single panel + agent marker
# --------------------------------------------------------------------------- #


def render_helicopter(env):
    import matplotlib.pyplot as plt

    grid = np.asarray(env.grid)
    pos = env.context["position"]
    row, col = int(pos[0]), int(pos[1])

    plt.style.use(FIGSTYLE)
    fig, ax = plt.subplots(figsize=FIGSIZE)
    fig.suptitle(_title(env), fontsize=32, color="0.4", ha="center")

    cells = [env._empty, env._tree, env._fire]
    norm, cmap = get_norm_cmap(cells, [COLOR_EMPTY, COLOR_TREE, COLOR_FIRE])
    plot_grid(ax, grid, aspect="equal", norm=norm, cmap=cmap)
    ax.plot(col, row, marker=helicopter_marker(), markersize=44, color="0.15",
            markeredgecolor="white", markeredgewidth=1.0)
    return fig


# --------------------------------------------------------------------------- #
# Bulldozer: 4 panels
# --------------------------------------------------------------------------- #


def _plot_gauge(ax, frac_time, color=COLOR_GAUGE):
    """Progress toward the next CA update (accu_time fraction in [0, 1))."""
    ax.barh(0.0, float(frac_time), height=0.1, color=color, edgecolor="None")
    ax.barh(0.0, 1.0, height=0.15, color="None", edgecolor="0.86")
    ax.set_xlim(-0.03, 1.1)
    ax.set_ylim(-0.4, 0.4)
    ax.set_xticks([0.0, 1.0])
    ax.set_yticks([0])
    ax.set_yticklabels(["CA"], size=14, color="0.6")
    clear_ax(ax, yticks=False)


def _plot_counts(ax, n_empty, n_tree, n_fire, colors=None):
    """Two stacked bars: forest (trees) vs not-forest (empty + fire)."""
    c_empty, c_tree, c_fire = colors or (COLOR_EMPTY, COLOR_TREE, COLOR_FIRE)
    total = n_empty + n_tree + n_fire
    ax.bar([0], [n_tree], width=0.1, color=c_tree)
    ax.bar([1], [n_empty], width=0.1, color=c_empty)
    ax.bar([1], [n_fire], width=0.1, bottom=[n_empty], color=c_fire)
    ax.set_xticks([0, 1])
    ax.set_xticklabels(["forest", "burned"], size=16)
    for label, color in zip(ax.get_xticklabels(), [c_tree, c_fire]):
        label.set_color(color)
    ax.set_ylim(-total * 0.1, total * 1.3)
    ax.set_xlim(-1, 2)
    ax.set_yticks(np.linspace(0, total, 3, dtype=int))
    clear_ax(ax, xticks=False)
    ax.grid(axis="y", color="0.94")


def _four_panels(fig):
    import matplotlib.pyplot as plt

    shape = (12, 14)
    ax_local = plt.subplot2grid(shape, (0, 0), colspan=8, rowspan=10, fig=fig)
    ax_global = plt.subplot2grid(shape, (0, 8), colspan=6, rowspan=6, fig=fig)
    ax_gauge = plt.subplot2grid(shape, (10, 0), colspan=8, rowspan=2, fig=fig)
    ax_counts = plt.subplot2grid(shape, (6, 8), colspan=6, rowspan=6, fig=fig)
    return ax_local, ax_global, ax_gauge, ax_counts


def render_bulldozer(env):
    """4-panel Bulldozer figure: local window, global grid w/ markers, CA
    gauge, forest-vs-burned counts."""
    import matplotlib.pyplot as plt

    grid = np.asarray(env.grid)
    pos = env.context["position"]
    time = env.context["time"]
    pos_fseed = env.context.get("pos_fire", getattr(env.core, "_pos_fire", None))

    cells = [env._empty, env._tree, env._fire]
    colors = [COLOR_EMPTY, COLOR_TREE, COLOR_FIRE]
    norm, cmap = get_norm_cmap(cells, colors)

    plt.style.use(FIGSTYLE)
    fig = plt.figure(figsize=FIGSIZE)
    fig.suptitle(_title(env), x=0.121, y=0.96, fontsize=32, color="0.6",
                 ha="left")
    ax_local, ax_global, ax_gauge, ax_counts = _four_panels(fig)

    # 1. local window (micromanagement view)
    lgrid = local_window(grid, pos, N_LOCAL, env._empty)
    plot_grid(ax_local, lgrid, interpolation="none", cmap=cmap, norm=norm)
    ax_local.plot(N_LOCAL, N_LOCAL, marker=bulldozer_marker(), markersize=42,
                  color="1.0", markeredgecolor="0.3")

    # 2. global grid (strategy view)
    ax_global.imshow(grid, interpolation="none", cmap=cmap, norm=norm)
    if pos_fseed is not None:
        ax_global.plot(pos_fseed[1], pos_fseed[0], marker="*", markersize=24,
                       color=COLOR_FIRE, markeredgecolor="0.3")
    ax_global.plot(int(pos[1]), int(pos[0]), marker=bulldozer_marker(),
                   markersize=22, color="1.0", markeredgecolor="0.3")
    clear_ax(ax_global)

    # 3. time gauge
    _plot_gauge(ax_gauge, float(np.asarray(time)) % 1.0)

    # 4. counts
    counts = env.count_cells()
    _plot_counts(ax_counts, counts[env._empty], counts[env._tree],
                 counts[env._fire])
    return fig


# --------------------------------------------------------------------------- #
# Advanced Bulldozer
# --------------------------------------------------------------------------- #

# Wind index -> direction angle (8 directions, index order of get_winds)
_WIND_ANGLES = np.linspace(0.0, 2 * np.pi, 8, endpoint=False)


def render_advanced(env, obs, info=None, env_idx: int = 0):
    """4-panel Advanced-Bulldozer figure for one env of the batch.

    ``obs`` is the (rgb, context) pair returned by ``env.reset()`` /
    ``env.stateless_step()``: the env is stateless, so the caller supplies
    the state to draw.
    """
    import matplotlib.pyplot as plt

    rgb, context = obs
    per_env = context["per_env_context"]
    i = env_idx
    # env i's leaves that the figure reads, to the host in one go
    env_i = _host({
        "rgb": rgb[i], "position": context["position"][i],
        "day_length": context["shared_context"]["day_length"],
        **{k: per_env[k][i] for k in ("true_grid", "is_night", "dousing_count",
                                      "wind_index", "time_step") if k in per_env},
    })

    true_grid = np.asarray(env_i["true_grid"])
    is_night = bool(np.asarray(env_i["is_night"]) > 0)
    dousing = np.asarray(env_i["dousing_count"])
    wind_index = int(np.asarray(env_i["wind_index"]))
    pos = np.asarray(env_i["position"])
    obs_rgb = np.asarray(env_i["rgb"]).astype(np.uint8)

    if is_night:
        colors = [COLOR_EMPTY_NIGHT, COLOR_TREE_NIGHT, COLOR_FIRE_NIGHT]
        gauge_color = COLOR_GAUGE_NIGHT
    else:
        colors = [COLOR_EMPTY, COLOR_TREE, COLOR_FIRE]
        gauge_color = COLOR_GAUGE
    cells = [env._empty, env._tree, env._fire]
    norm, cmap = get_norm_cmap(cells, colors)

    plt.style.use(FIGSTYLE)
    fig = plt.figure(figsize=FIGSIZE)
    phase = "night" if is_night else "day"
    fig.suptitle(f"{_title(env)} [{phase}]", x=0.121, y=0.96, fontsize=32,
                 color="0.6", ha="left")
    ax_local, ax_global, ax_gauge, ax_counts = _four_panels(fig)

    # 1. the agent's actual RGB observation (day/night palette + blur +
    #    extensions applied)
    ax_local.imshow(obs_rgb, interpolation="none")
    ax_local.set_title("agent observation", color="0.5")
    clear_ax(ax_local)

    # 2. global true grid + dousing overlay + wind arrow + agent marker
    ax_global.imshow(true_grid, interpolation="none", cmap=cmap, norm=norm)
    if dousing.any():
        overlay = np.zeros(dousing.shape + (4,), np.float32)
        overlay[dousing > 0] = (0.25, 0.5, 1.0, 0.6)  # water-blue tint
        ax_global.imshow(overlay, interpolation="none")
    ax_global.plot(int(pos[1]), int(pos[0]), marker=bulldozer_marker(),
                   markersize=20, color="1.0", markeredgecolor="0.3")
    h, w = true_grid.shape
    ang = _WIND_ANGLES[wind_index % 8]
    ax_global.annotate(
        "", xy=(w * 0.12 + w * 0.08 * np.cos(ang), h * 0.12 - h * 0.08 * np.sin(ang)),
        xytext=(w * 0.12, h * 0.12),
        arrowprops=dict(arrowstyle="-|>", color="0.2", lw=2),
    )
    ax_global.set_title("true state", color="0.5")
    clear_ax(ax_global)

    # 3. day/night gauge (progress through the current day_length period)
    day_length = int(np.asarray(env_i["day_length"]))
    t = int(np.asarray(env_i["time_step"])) if "time_step" in env_i else 0
    _plot_gauge(ax_gauge, (t % day_length) / max(day_length, 1), gauge_color)

    # 4. counts on the true grid
    n_empty = int((true_grid == env._empty).sum())
    n_tree = int((true_grid == env._tree).sum())
    n_fire = int((true_grid == env._fire).sum())
    _plot_counts(ax_counts, n_empty, n_tree, n_fire, colors)
    return fig


def plot_grid_attribute(grid, attribute_name: str):
    """Heatmap of a terrain attribute (altitude / density / vegetation) with
    a labeled horizontal colorbar."""
    import matplotlib.pyplot as plt

    grid = np.asarray(_host(grid))
    vmin, vmax = float(grid.min()), float(grid.max())
    n_ranges = 5
    span = (vmax - vmin) or 1.0
    values = [vmin + i * span / n_ranges for i in range(n_ranges + 1)]
    colors = ["#FFF5F0", "#FEE0D2", "#FCBBA1", "#FC9272", "#FB6A4A", "#CB181D"]
    norm, cmap = get_norm_cmap(values, colors)

    plt.style.use(FIGSTYLE)
    fig, ax = plt.subplots()
    im = ax.imshow(grid, interpolation="none", cmap=cmap, norm=norm)
    cbar = fig.colorbar(im, ax=ax, label=attribute_name,
                        orientation="horizontal")
    cbar.set_ticks(values)
    cbar.set_ticklabels([f"{v:.1f}" for v in values])
    ax.set_title(attribute_name)
    clear_ax(ax)
    return fig
