"""Icosphere generation and triangular patch-table construction (numpy).

The port's own copy of ``surface_vision_transformers_tpu.geometry.icosphere``
(the port imports nothing of the JAX package); the tables it generates equal
the JAX package's id for id. The reference framework ships the ico-6 patch
tables only for sub-ico 1 and 2, as CSV assets with no generator; here ico-N
spheres come from repeated midpoint subdivision of the icosahedron and the
patch tables for any (ico, sub_ico) from them, so finer grids (sub-ico-3,
1,280 patches x 45 vertices for SiT-base) are not data-blocked.

Patch semantics (matching the reference's tables structurally):
  * the patching grid at level ``k`` has ``20 * 4**k`` patches — the faces of
    ico-k;
  * each patch contains every ico-N vertex that lies on that face, i.e. the
    full barycentric triangular grid of resolution ``r = 2**(N-k)``, giving
    ``(r+1)(r+2)/2`` vertices per patch;
  * border vertices are shared by (duplicated into) adjacent patches, and the
    union of all patches covers all ``10 * 4**N + 2`` vertices.

NOTE on vertex ordering: vertex ids produced here follow this module's
canonical subdivision order. They intentionally do NOT reproduce the reference
CSVs' ordering (which follows an external atlas mesh); to consume dHCP data
preprocessed for that ordering, load the shipped tables via
``tables.load_patch_table`` instead of generating them.
"""

from __future__ import annotations

import functools

import numpy as np

# Golden-ratio icosahedron --------------------------------------------------


def icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Return (vertices (12, 3) float64 unit-norm, faces (20, 3) int32)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int32,
    )
    return verts, faces


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def subdivide(
    verts: np.ndarray, faces: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """One midpoint-subdivision step: each face splits into 4.

    New vertices (normalized edge midpoints) are appended after the existing
    ones, deduplicated per undirected edge, so vertex ids are stable across
    levels (ico-k vertices are a prefix of ico-(k+1) vertices).
    """
    verts = list(map(tuple, verts))
    midpoint_cache: dict[tuple[int, int], int] = {}
    v_arr = np.asarray(verts, dtype=np.float64)
    new_verts = [v_arr]

    def midpoint(a: int, b: int) -> int:
        key = (a, b) if a < b else (b, a)
        idx = midpoint_cache.get(key)
        if idx is None:
            m = _normalize((v_arr[a] + v_arr[b]) / 2.0)
            idx = len(v_arr) + len(new_verts) - 1
            new_verts.append(m[None, :])
            midpoint_cache[key] = idx
        return idx

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces.extend([[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]])

    return np.concatenate(new_verts, axis=0), np.asarray(new_faces, np.int32)


@functools.lru_cache(maxsize=None)
def icosphere(order: int) -> tuple[np.ndarray, np.ndarray]:
    """ico-``order`` sphere: (vertices (10*4^order+2, 3), faces (20*4^order, 3))."""
    if order < 0:
        raise ValueError(f"order must be >= 0, got {order}")
    verts, faces = icosahedron()
    for _ in range(order):
        verts, faces = subdivide(verts, faces)
    verts.setflags(write=False)
    faces.setflags(write=False)
    return verts, faces


def num_vertices(order: int) -> int:
    return 10 * 4**order + 2


def num_faces(order: int) -> int:
    return 20 * 4**order


def patch_grid(ico: int, sub_ico: int) -> tuple[int, int]:
    """(num_patches, vertices_per_patch) for patching ico-``ico`` at level
    ``sub_ico`` — the geometry source of truth (the reference duplicates these
    numbers as literal YAML blocks, config/SiT/training/hparams.yml:71-81)."""
    if not 0 <= sub_ico <= ico:
        raise ValueError(f"need 0 <= sub_ico <= ico, got {sub_ico}, {ico}")
    r = 2 ** (ico - sub_ico)
    return num_faces(sub_ico), (r + 1) * (r + 2) // 2


# Patch-table generation -----------------------------------------------------


def _face_grid_ids(
    corners: tuple[int, int, int], r: int, edge_cache: dict, verts: list
) -> np.ndarray:
    """Vertex ids of the barycentric grid of resolution ``r`` on one face.

    Grid point (i, j) (0 <= i + j <= r) corresponds to barycentric position
    ((r-i-j), i, j)/r over corners (A, B, C); ids are produced by recursive
    midpoint refinement so they coincide with ids from `subdivide` chains when
    seeded with the same top-level mesh.
    """
    # The grid doubles its resolution per step through edge midpoints, which
    # matches repeated midpoint subdivision exactly.
    if r < 1 or r & (r - 1):
        raise ValueError(f"resolution must be a power of two, got {r}")

    def vid(a: int, b: int) -> int:
        key = (a, b) if a < b else (b, a)
        idx = edge_cache.get(key)
        if idx is None:
            m = _normalize((np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0)
            verts.append(m)
            idx = len(verts) - 1
            edge_cache[key] = idx
        return idx

    # grid[(i, j)] = vertex id at barycentric (i, j) on resolution `res`
    grid = {(0, 0): corners[0], (1, 0): corners[1], (0, 1): corners[2]}
    res = 1
    while res < r:
        new = {}
        for (i, j), g in grid.items():
            new[(2 * i, 2 * j)] = g
        for i in range(res + 1):
            for j in range(res + 1 - i):
                # midpoints toward (i+1, j), (i, j+1), and diagonal (i+1, j-1)
                if i + 1 + j <= res:
                    new[(2 * i + 1, 2 * j)] = vid(grid[(i, j)], grid[(i + 1, j)])
                    new[(2 * i, 2 * j + 1)] = vid(grid[(i, j)], grid[(i, j + 1)])
                    new[(2 * i + 1, 2 * j + 1)] = vid(
                        grid[(i + 1, j)], grid[(i, j + 1)]
                    )
        grid = new
        res *= 2

    out = np.empty((r + 1) * (r + 2) // 2, dtype=np.int32)
    n = 0
    for i in range(r + 1):
        for j in range(r + 1 - i):
            out[n] = grid[(i, j)]
            n += 1
    return out


def generate_patch_table(
    ico: int, sub_ico: int
) -> tuple[np.ndarray, np.ndarray]:
    """Generate a patch table for ico-``ico`` patched at level ``sub_ico``.

    Returns ``(table, verts)``: ``table`` is (num_patches, vertices_per_patch)
    int32 — row p lists the vertex ids covered by face p of ico-``sub_ico``
    (borders duplicated across adjacent patches) — and ``verts`` is the
    (10*4^ico + 2, 3) float64 coordinate array those ids index. The id order
    is per-face discovery order (ico-``sub_ico`` vertices first); use
    ``remap_table_to_icosphere`` to re-index into ``icosphere(ico)`` order.
    """
    n_patches, n_per_patch = patch_grid(ico, sub_ico)
    base_verts, base_faces = icosphere(sub_ico)
    r = 2 ** (ico - sub_ico)

    verts: list = [np.asarray(v) for v in base_verts]
    edge_cache: dict = {}
    table = np.empty((n_patches, n_per_patch), dtype=np.int32)
    for p, (a, b, c) in enumerate(base_faces):
        table[p] = _face_grid_ids((int(a), int(b), int(c)), r, edge_cache, verts)

    total = num_vertices(ico)
    if len(verts) != total or np.unique(table).size != total:
        raise RuntimeError(f"generated {len(verts)} vertices, expected {total}")
    return table, np.stack(verts, axis=0)


def remap_table_to_icosphere(
    table: np.ndarray, verts: np.ndarray, ico: int
) -> np.ndarray:
    """Re-index a generated patch table so its ids index ``icosphere(ico)[0]``.

    Both vertex sets come from identical midpoint arithmetic, so coordinates
    match bit-exactly and can be joined on raw float bytes.
    """
    target_verts, _ = icosphere(ico)
    lookup = {v.tobytes(): i for i, v in enumerate(np.asarray(target_verts))}
    remap = np.array([lookup[v.tobytes()] for v in np.asarray(verts)], np.int32)
    return remap[table]
