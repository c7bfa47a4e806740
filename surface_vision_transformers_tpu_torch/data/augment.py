"""Surface augmentation on the device: exact icosahedral rotations and
barycentric warps (counterpart of ``surface_vision_transformers_tpu.data.
augment.SurfaceAugment``).

The geometry is precomputed once into numpy gather(+blend) tables, the same
tables the JAX package builds for the same ``seed`` and sphere; a batch is
augmented on its own device with torch index ops:

* a rotation is one gather of each sample's vertex axis through its
  rotation's permutation;
* a warp is, for each table, three gathers of the samples that take it
  through the table's corner indices, each times its barycentric weights,
  summed in the order t0 + t1 + t2 (JAX's ``_apply_warps``) and written back
  over those samples.

Both input layouts are covered: raw (B, C, G) vertex arrays index the vertex
axis directly; pre-patched (B, C, L, V) arrays use the vertex tables composed
with the patch table (vertex -> its first (l, v) slot) over the flattened
L*V axis.

Randomness is explicit. ``draw`` takes a ``torch.Generator`` and returns the
draws (``Draws``): each sample's rotation index, and the warp assignment by
the configured law --

* 'quota' (default): a permutation of the batch; exactly round(warp_prob*B)
  samples warp, its first positions split base + (k < rem) across the K
  tables in order;
* 'multinomial': a per-sample on-flag (uniform < warp_prob) and table;
* ``warp_per_batch``: a per-sample on-flag and one table for the batch.

``apply`` takes draws made anywhere (the tests feed it JAX's), so the port
and the JAX package agree sample for sample on the same draws.
``reference`` applies the same tables with numpy, the plain version the
device result is held against.

Not carried over: the JAX package's structured rotation path for patched
input (a patch-block gather and one-hot orientation GEMMs through
``ops/exact_move.py``), a TPU workaround that is bit-equal to the general
gather; here the general gather runs on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from surface_vision_transformers_tpu_torch.geometry import rotations as rot
from surface_vision_transformers_tpu_torch.geometry.icosphere import num_vertices

WARP_LAWS = ("quota", "multinomial")


def _vertex_to_patch_slot(indices: np.ndarray, num_vertices_total: int) -> np.ndarray:
    """inv[g] = first flattened (l*V + v) slot holding vertex g."""
    flat = indices.reshape(-1)
    inv = np.full((num_vertices_total,), -1, np.int64)
    # reversed so the FIRST occurrence wins
    inv[flat[::-1]] = np.arange(flat.size - 1, -1, -1)
    if not (inv >= 0).all():
        raise ValueError("patch table does not cover the mesh")
    return inv


@dataclasses.dataclass
class Draws:
    """One batch's augmentation draws: ``rot`` (B,) rotation indices, and
    per sample whether it warps (``on``, (B,) bool) and through which table
    (``table``, (B,) int). ``on`` is None when no sample can warp."""

    rot: torch.Tensor
    on: torch.Tensor | None = None
    table: torch.Tensor | None = None

    def take(self, rows: torch.Tensor) -> "Draws":
        """The draws of samples ``rows`` of the batch (a rank's rows under a
        mesh: the global batch's draws, cut)."""
        return Draws(rot=self.rot[rows], on=None if self.on is None else self.on[rows],
                     table=None if self.table is None else self.table[rows])


class SurfaceAugment:
    """Precomputed augmentation tables and their application.

    Args:
      ico: icosphere order of the data (canonical ordering unless
        ``mesh_verts`` / ``mesh_faces`` give the sphere in the data's own
        vertex numbering, e.g. an atlas sphere).
      patch_table: (L, V) table, required to augment pre-patched input.
      exact_rotations: draw among the 60 icosahedral rotations (else the
        identity only).
      num_warps: number of warp tables (barycentric resampling of a random
        rotation of up to ``max_warp_deg`` degrees).
      warp_prob: share of the samples that are warped as well.
      warp_per_batch: one table for every warped sample of a batch.
      warp_assign: 'quota' or 'multinomial' (see the module docstring).
      seed: numpy seed of the warp tables.
    """

    def __init__(self, ico: int = 6, patch_table: np.ndarray | None = None, *,
                 exact_rotations: bool = True, num_warps: int = 8,
                 max_warp_deg: float = 15.0, warp_prob: float = 0.5,
                 warp_per_batch: bool = False, warp_assign: str = "quota",
                 seed: int = 0, mesh_verts: np.ndarray | None = None,
                 mesh_faces: np.ndarray | None = None):
        if warp_assign not in WARP_LAWS:
            raise ValueError(f"unknown warp_assign {warp_assign!r}")
        self.patch_table = None if patch_table is None else np.asarray(patch_table)
        self.num_warps = num_warps
        self.warp_prob = warp_prob
        self.warp_per_batch = warp_per_batch
        self.warp_assign = warp_assign
        G = num_vertices(ico)
        rng = np.random.default_rng(seed)

        if exact_rotations:
            self._perms = rot.exact_rotation_permutations(ico, mesh_verts)
        else:
            self._perms = np.arange(G, dtype=np.int32)[None]

        widx, ww = [], []
        for _ in range(num_warps):
            R = rot.random_rotation_matrix(rng, max_warp_deg)
            i, w = rot.barycentric_resample_table(ico, R, mesh_verts, mesh_faces)
            widx.append(i)
            ww.append(w)
        self._warp_idx = np.stack(widx) if num_warps else None  # (K, G, 3)
        self._warp_w = np.stack(ww) if num_warps else None  # (K, G, 3)

        if self.patch_table is not None:
            inv = _vertex_to_patch_slot(self.patch_table, G)
            flat = self.patch_table.reshape(-1)
            self._perms_patched = inv[self._perms[:, flat]].astype(np.int32)  # (R, L*V)
            if num_warps:
                self._warp_idx_patched = inv[self._warp_idx[:, flat]].astype(np.int32)
                self._warp_w_patched = self._warp_w[:, flat]
        self._device_tables: dict = {}

    @property
    def warps(self) -> bool:
        """Whether any sample can be warped."""
        return self.num_warps > 0 and self.warp_prob > 0

    def tables(self, patched: bool) -> tuple:
        """(perms (R, F), warp_idx (K, F, 3) | None, warp_w (K, F, 3) | None)
        in numpy over the vertex axis (F = G) or the flattened patch axis
        (F = L*V)."""
        if not patched:
            return self._perms, self._warp_idx, self._warp_w
        if self.patch_table is None:
            raise ValueError("pre-patched input needs patch_table set")
        if not self.num_warps:
            return self._perms_patched, None, None
        return self._perms_patched, self._warp_idx_patched, self._warp_w_patched

    def _on_device(self, patched: bool, device: torch.device) -> tuple:
        key = (patched, str(device))
        if key not in self._device_tables:
            perms, widx, ww = self.tables(patched)
            self._device_tables[key] = (
                torch.from_numpy(perms.astype(np.int64)).to(device),
                None if widx is None else torch.from_numpy(widx.astype(np.int64)).to(device),
                None if ww is None else torch.from_numpy(ww).to(device))
        return self._device_tables[key]

    # -- draws ----------------------------------------------------------------

    def quota_assign(self, perm) -> tuple[torch.Tensor, torch.Tensor]:
        """(on, table) per sample from a permutation of the batch under the
        'quota' law: the sample at position s of ``perm`` warps when s <
        round(warp_prob * B), through table k for s in the k-th of K
        consecutive slices of base + (k < rem) positions."""
        perm = torch.from_numpy(np.array(perm, dtype=np.int64))
        B, K = perm.numel(), self.num_warps
        m_on = int(round(self.warp_prob * B))
        base, rem = divmod(m_on, K)
        counts = [base + (k < rem) for k in range(K)]
        slot_table = torch.repeat_interleave(torch.arange(K), torch.tensor(counts))
        on, table = torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.int64)
        on[perm[:m_on]] = True
        table[perm[:m_on]] = slot_table
        return on, table

    def draw(self, batch: int, generator: torch.Generator) -> Draws:
        """The draws of one batch of ``batch`` samples from ``generator``
        (a CPU generator: the draws are (B,) vectors), in a fixed order:
        rotations, then the warp law's draws."""
        r = torch.randint(self._perms.shape[0], (batch,), generator=generator)
        if not self.warps:
            return Draws(rot=r)
        K = self.num_warps
        if self.warp_per_batch:
            on = torch.rand(batch, generator=generator) < self.warp_prob
            t0 = torch.randint(K, (), generator=generator)
            return Draws(rot=r, on=on, table=t0.expand(batch).clone())
        if self.warp_assign == "quota":
            on, table = self.quota_assign(torch.randperm(batch, generator=generator))
            return Draws(rot=r, on=on, table=table)
        on = torch.rand(batch, generator=generator) < self.warp_prob
        return Draws(rot=r, on=on, table=torch.randint(K, (batch,), generator=generator))

    # -- application ----------------------------------------------------------

    def apply(self, x: torch.Tensor, draws: Draws) -> torch.Tensor:
        """Augment raw (B, C, G) or pre-patched (B, C, L, V) ``x`` on its
        device with the given draws."""
        if x.dim() not in (3, 4):
            raise ValueError(f"bad input shape {tuple(x.shape)}")
        patched = x.dim() == 4
        shape = x.shape
        B, C = shape[:2]
        flat = x.reshape(B, C, -1)
        perms, widx, ww = self._on_device(patched, x.device)
        r = draws.rot.to(x.device)
        out = torch.gather(flat, 2, perms[r][:, None, :].expand(flat.shape))
        if draws.on is not None and widx is not None:
            # one table at a time over the samples that take it: three
            # gathers of a (F,) index each, the weights cast to x's dtype
            on, table = draws.on.cpu(), draws.table.cpu()
            for k in range(self.num_warps):
                rows = torch.nonzero(on & (table == k)).reshape(-1)
                if rows.numel() == 0:
                    continue
                rows = rows.to(x.device)
                xs = out.index_select(0, rows)
                w = ww[k].to(x.dtype)
                warped = (xs.index_select(2, widx[k, :, 0]) * w[:, 0]
                          + xs.index_select(2, widx[k, :, 1]) * w[:, 1]
                          + xs.index_select(2, widx[k, :, 2]) * w[:, 2])
                out.index_copy_(0, rows, warped)
        return out.reshape(shape)

    def __call__(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return self.apply(x, self.draw(x.shape[0], generator))

    def reference(self, x: np.ndarray, draws: Draws) -> np.ndarray:
        """``apply`` in numpy, sample by sample: the plain version."""
        patched = x.ndim == 4
        perms, widx, ww = self.tables(patched)
        B, C = x.shape[:2]
        flat = x.reshape(B, C, -1)
        out = np.empty_like(flat)
        rot_ = draws.rot.cpu().numpy()
        on = None if draws.on is None else draws.on.cpu().numpy()
        table = None if draws.table is None else draws.table.cpu().numpy()
        for b in range(B):
            y = flat[b][:, perms[rot_[b]]]
            if on is not None and widx is not None and on[b]:
                k = table[b]
                w = ww[k].astype(x.dtype)
                y = (y[:, widx[k, :, 0]] * w[:, 0] + y[:, widx[k, :, 1]] * w[:, 1]
                     + y[:, widx[k, :, 2]] * w[:, 2])
            out[b] = y
        return out.reshape(x.shape)
