"""Icosahedral rotations and spherical interpolation tables for augmentation
(numpy; the port's own copy of ``surface_vision_transformers_tpu.geometry.
rotations``, whose tables it reproduces exactly).

Two mechanisms, both reduced to static gather(+blend) tables that
``data.augment.SurfaceAugment`` applies on the device:

  * exact rotations: the 60-element icosahedral rotation group maps the
    icosphere vertex set onto itself, so each rotation is an exact vertex
    PERMUTATION (no resampling error);
  * warps / arbitrary rotations: any rotation (e.g. small random angles)
    resamples the sphere; each rotated vertex is located on the icosphere
    via nearest-neighbour + incident-triangle search and expressed as
    barycentric weights over one triangle -> a (G, 3) index + (G, 3) weight
    table, applied as gather + weighted sum.

Tables use the canonical icosphere coordinates (``geometry.icosphere``); for
atlas meshes with different vertex numbering, pass the atlas coordinates.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.spatial import cKDTree

from surface_vision_transformers_tpu_torch.geometry.icosphere import icosphere


@functools.lru_cache(maxsize=1)
def icosahedral_rotation_group() -> np.ndarray:
    """(60, 3, 3) proper rotation matrices of the icosahedron, generated by
    closure of a 5-fold vertex rotation and a 3-fold face rotation."""
    verts, faces = icosphere(0)

    def axis_rotation(axis, angle):
        axis = axis / np.linalg.norm(axis)
        K = np.array(
            [
                [0, -axis[2], axis[1]],
                [axis[2], 0, -axis[0]],
                [-axis[1], axis[0], 0],
            ]
        )
        return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K

    g1 = axis_rotation(np.asarray(verts[0]), 2 * np.pi / 5)
    face_center = np.asarray(verts[list(faces[0])]).mean(axis=0)
    g2 = axis_rotation(face_center, 2 * np.pi / 3)

    group = [np.eye(3)]
    frontier = [np.eye(3)]
    while frontier:
        nxt = []
        for r in frontier:
            for g in (g1, g2):
                cand = g @ r
                # tolerance dedup: byte-exact keys split equal rotations on
                # floating-point drift
                if not any(np.abs(cand - m).max() < 1e-6 for m in group):
                    group.append(cand)
                    nxt.append(cand)
        frontier = nxt
    mats = np.stack(group)
    assert mats.shape[0] == 60, mats.shape[0]
    return mats


def exact_rotation_permutations(ico: int, verts=None) -> np.ndarray:
    """(60, G) int32: perm[r, i] = index of the vertex that rotation r maps
    onto vertex i, i.e. rotated_data[i] = data[perm[r, i]].

    ``verts`` overrides the canonical icosphere coordinates (e.g. an atlas
    sphere with its own vertex numbering); it must still be an icosphere
    aligned with the icosahedral axes for the rotations to be exact."""
    verts = np.asarray(icosphere(ico)[0] if verts is None else verts)
    tree = cKDTree(verts)
    mats = icosahedral_rotation_group()
    perms = np.empty((60, verts.shape[0]), np.int32)
    for r, R in enumerate(mats):
        # vertex j lands at R @ v_j; the value seen AT position i comes from
        # the vertex that lands on v_i: R^T v_i
        src = verts @ R  # == (R.T @ v_i)^T rows
        dist, idx = tree.query(src, k=1, workers=-1)
        if dist.max() > 1e-6:
            raise ValueError(
                f"rotation {r} does not map the vertex set to itself "
                f"(max dist {dist.max():.2e})"
            )
        perms[r] = idx
    return perms


def barycentric_resample_table(
    ico: int, rotation: np.ndarray, verts=None, faces=None
) -> tuple[np.ndarray, np.ndarray]:
    """Resampling table for an ARBITRARY rotation (or any smooth map):
    returns (indices (G, 3) int32, weights (G, 3) float32) such that
    rotated_data[i] = sum_k w[i, k] * data[idx[i, k]].

    Each target position R^T v_i is located in a triangle incident to its
    nearest vertex; weights are spherical-triangle barycentric coordinates
    (normalized linear weights, exact at vertices, smooth inside)."""
    c_verts, c_faces = icosphere(ico)
    verts = np.asarray(c_verts if verts is None else verts)
    faces = np.asarray(c_faces if faces is None else faces)
    G = verts.shape[0]

    # incident faces per vertex (6, except 5 at the 12 original vertices),
    # each vertex's in increasing face order (the first best face wins below)
    corner = faces.reshape(-1).astype(np.int64)
    order = np.argsort(corner, kind="stable")
    counts = np.bincount(corner, minlength=G)
    max_inc = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(order.size) - np.repeat(starts, counts)
    inc = np.full((G, max_inc), -1, np.int64)
    inc[corner[order], rank] = order // 3

    tree = cKDTree(verts)
    pts = verts @ rotation  # target position for output vertex i
    _, nearest = tree.query(pts, k=1, workers=-1)

    cand_faces = inc[nearest]  # (G, max_inc)
    corner_ids = np.where(
        cand_faces[..., None] >= 0, faces[cand_faces], 0
    )  # (G, max_inc, 3)
    corners = verts[corner_ids]  # (G, max_inc, 3, 3)

    # solve p = a*A + b*B + c*C per candidate face (3x3 solve, vectorized)
    M = np.swapaxes(corners, -1, -2)  # columns are corner vectors
    sol = np.linalg.solve(
        M + 1e-12 * np.eye(3), np.broadcast_to(pts[:, None, :], M.shape[:-1])[..., None]
    ).squeeze(-1)  # (G, max_inc, 3)
    valid = (cand_faces >= 0) & (sol.min(axis=-1) > -1e-6)
    # prefer the face with the largest minimum coordinate (most interior)
    score = np.where(valid, sol.min(axis=-1), -np.inf)
    best = score.argmax(axis=1)
    rows = np.arange(G)
    w = sol[rows, best]
    w = np.clip(w, 0.0, None)
    w = w / w.sum(axis=1, keepdims=True)
    idx = corner_ids[rows, best]
    return idx.astype(np.int32), w.astype(np.float32)


def random_rotation_matrix(rng: np.random.Generator, max_angle_deg: float) -> np.ndarray:
    """Uniform random axis, uniform angle in [0, max_angle_deg]."""
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.uniform(0, max_angle_deg))
    K = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
