"""The backward chains' route rules on the CPU, pinned at the shapes the
port trains: MS-SiT's seven folds of a batch of 64 (``mssit_scan_age.yml``,
head dim 32), the valid_len edges the chip check runs beside them, and
SiT-tiny and SiT-base (head dim 64).

Each rule is a plain Python function that states what the kernels do on the
card (``csrc/flash_attention.cu``, ``csrc/fused_block_bwd.cu``,
``csrc/gemm.cuh``): which attention backwards keep the whole sequence in
shared memory and how many sequences a tile packs, which widths fold the
LayerNorm backward into the epilogue of dh's product, and the fp32
workspace and dh scratch each backward asks for. ``chip_smoke.py`` holds
the workspace and dh rules against the C entries on the card. Exact
integers: no tolerance.
"""

import pytest

from surface_vision_transformers_tpu_torch.ops import flash_attention as fa
from surface_vision_transformers_tpu_torch.ops import fused_block as fb

# name: (sequences, N, query rows, dim, heads, dim_head), then (resident,
# pack, attention workspace floats, LayerNorm in the epilogue, block
# backward workspace floats, dh scratch floats)
SHAPES = {
    "stage 0 window": ((20480, 64, 64, 96, 3, 32), (True, 1, 0, True, 3932160, 0)),
    "stage 0 axial": ((4096, 320, 320, 96, 3, 32), (True, 1, 0, True, 3932160, 0)),
    "stage 1 window": ((5120, 64, 64, 192, 6, 32), (True, 1, 0, True, 3096576, 0)),
    "stage 1 axial": ((4096, 80, 80, 192, 6, 32), (True, 1, 0, True, 3096576, 0)),
    "stage 2 window": ((1280, 64, 64, 384, 12, 32), (True, 1, 0, False, 6488064, 31457280)),
    "stage 2 axial": ((4096, 20, 20, 384, 12, 32), (True, 3, 0, False, 6488064, 31457280)),
    "stage 3 global": ((64, 320, 320, 768, 24, 32), (True, 1, 0, False, 12386304, 15728640)),
    "edge N 80 valid_len 70": ((256, 80, 80, 192, 6, 32), (True, 1, 0, True, 2949120, 0)),
    "edge N 320 valid_len 300": ((64, 320, 320, 96, 3, 32), (True, 1, 0, True, 1474560, 0)),
    "edge N 400 valid_len 390": ((32, 400, 400, 96, 3, 32),
                                 (False, 1, 5507712, True, 5507712, 0)),
    "edge N 20 valid_len 15": ((4096, 20, 20, 384, 12, 32),
                               (True, 3, 0, False, 6488064, 31457280)),
    "SiT-tiny B=256": ((256, 321, 321, 192, 3, 64), (False, 1, 75515904, True, 75515904, 0)),
    "SiT-tiny CLS block": ((256, 321, 8, 192, 3, 64),
                           (False, 1, 12585984, True, 12585984, 15777792)),
    "SiT-base B=128": ((128, 1281, 1281, 768, 12, 64),
                       (False, 1, 528611328, False, 528611328, 125927424)),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_attention_backward_route(name):
    """The resident backward at head dim 32 (every MS-SiT fold and edge:
    N <= 320, queries = keys), packing 64 // N sequences where N <= 32 (stage
    2's axial fold: 3 of 20 rows, 60 rows a tile); the streamed kernels at
    head dim 64 and for the CLS block's 8 queries against N keys."""
    (B, N, rows, _, heads, dh), (resident, pack, ws, _, _, _) = SHAPES[name]
    assert fa.resident_bwd(rows, N, dh) is resident
    assert fa.resident_pack(N) == pack
    assert fa.bwd_workspace_floats(B, heads, rows, N, dh) == ws
    assert not fa.resident_bwd(rows, N, dh, dropout=True)


@pytest.mark.parametrize("name", list(SHAPES))
def test_layernorm_in_epilogue_route(name):
    """The LayerNorm backwards fold into dh's product at widths up to the
    GEMM engine's 192-column tile, whatever the head dim (MS-SiT stages 0-1,
    SiT-tiny); stages 2-3 and SiT-base run the standalone pass."""
    (_, _, _, dim, _, _), (_, _, _, fused, _, _) = SHAPES[name]
    assert fb.ln_in_epilogue(dim) is fused


@pytest.mark.parametrize("name", list(SHAPES))
def test_block_backward_workspace(name):
    """``svt_block_bwd_workspace``'s floats: the largest of the split-K and
    column partials, or the attention backward's dQ sums, which the
    resident kernel no longer needs (the parent asked 503 M floats, 2 GB,
    at stage 0's window fold)."""
    (B, N, rows, dim, heads, dh), (_, _, ws, _, block_ws, _) = SHAPES[name]
    assert fb.block_bwd_workspace(B, N, rows, dim, heads, dh, 4 * dim) == block_ws
    assert block_ws >= ws


@pytest.mark.parametrize("name", list(SHAPES))
def test_block_backward_dh_scratch(name):
    """``svt_block_bwd_dh_floats``: the fp32 dh the chain writes, B * N *
    dim where a standalone LayerNorm backward reads it (dims past 192, and
    the CLS block, whose LN1 dh is two products), else none."""
    (B, N, rows, dim, _, _), (_, _, _, fused, _, dh_floats) = SHAPES[name]
    cls = rows < N
    assert fb.block_bwd_dh_floats(B, N, dim, cls) == dh_floats
    assert (dh_floats == 0) is (fused and not cls)


def test_resident_limits():
    """The resident kernel's edges: 320 keys at most, queries = keys, head
    dim 32 only; a pack never overfills the 64-row tile."""
    assert fa.resident_bwd(320, 320, 32) and not fa.resident_bwd(321, 321, 32)
    assert not fa.resident_bwd(64, 80, 32) and not fa.resident_bwd(64, 64, 64)
    for n in range(1, 65):
        assert fa.resident_pack(n) * n <= 64
        assert fa.resident_pack(n) == (64 // n if n <= 32 else 1)
