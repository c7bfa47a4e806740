"""The backward chains' route rules on the CPU, pinned at the shapes the
port trains: MS-SiT's seven folds of a batch of 64 (``mssit_scan_age.yml``,
head dim 32), the valid_len edges the chip check runs beside them, and
SiT-tiny, SiT-small width and SiT-base (head dim 64), with their CLS blocks.

Each rule is a plain Python function that states what the kernels do on the
card (``csrc/flash_attention.cu``, ``csrc/fused_block_bwd.cu``,
``csrc/gemm.cuh``): which attention backwards keep the whole sequence in
shared memory and how many sequences a tile packs, which take the few-query
kernel (the CLS block's 8 query rows against every key), which widths fold the
LayerNorm backward into the epilogue of dh's product, and the fp32
workspace and dh scratch each backward asks for. ``chip_smoke.py`` holds
the workspace and dh rules against the C entries on the card. Exact
integers: no tolerance.
"""

import pytest

from surface_vision_transformers_tpu_torch.ops import flash_attention as fa
from surface_vision_transformers_tpu_torch.ops import fused_block as fb

# name: (sequences, N, query rows, dim, heads, dim_head), then (resident,
# pack, few-query, attention workspace floats, LayerNorm in the epilogue,
# block backward workspace floats, dh scratch floats)
SHAPES = {
    "stage 0 window": ((20480, 64, 64, 96, 3, 32), (True, 1, False, 0, True, 3932160, 0)),
    "stage 0 axial": ((4096, 320, 320, 96, 3, 32), (True, 1, False, 0, True, 3932160, 0)),
    "stage 1 window": ((5120, 64, 64, 192, 6, 32), (True, 1, False, 0, True, 3096576, 0)),
    "stage 1 axial": ((4096, 80, 80, 192, 6, 32), (True, 1, False, 0, True, 3096576, 0)),
    "stage 2 window": ((1280, 64, 64, 384, 12, 32),
                       (True, 1, False, 0, False, 6488064, 31457280)),
    "stage 2 axial": ((4096, 20, 20, 384, 12, 32), (True, 3, False, 0, False, 6488064, 31457280)),
    "stage 3 global": ((64, 320, 320, 768, 24, 32),
                       (True, 1, False, 0, False, 12386304, 15728640)),
    "edge N 80 valid_len 70": ((256, 80, 80, 192, 6, 32), (True, 1, False, 0, True, 2949120, 0)),
    "edge N 320 valid_len 300": ((64, 320, 320, 96, 3, 32),
                                 (True, 1, False, 0, True, 1474560, 0)),
    "edge N 400 valid_len 390": ((32, 400, 400, 96, 3, 32),
                                 (False, 1, False, 5507712, True, 5507712, 0)),
    "edge N 20 valid_len 15": ((4096, 20, 20, 384, 12, 32),
                               (True, 3, False, 0, False, 6488064, 31457280)),
    "SiT-tiny B=256": ((256, 321, 321, 192, 3, 64),
                       (False, 1, False, 75515904, True, 75515904, 0)),
    # the CLS block's 8 query rows: the few-query kernel, no attention
    # workspace; at dim 192 LN1 in dkv W_kv's epilogue (no dh), its
    # workspace the largest split-K partials (dW_fc1 and dW_kv, 21 and 42
    # splits: 3,096,576 floats) above the dq W_q share and its column
    # partials (2048 x 192 + 132 x 2 x 192 = 443,904)
    "SiT-tiny CLS block": ((256, 321, 8, 192, 3, 64), (False, 1, True, 0, True, 3096576, 0)),
    "SiT-small CLS block": ((256, 321, 8, 384, 6, 64),
                            (False, 1, True, 0, False, 6488064, 31555584)),
    "SiT-base CLS block": ((32, 1281, 8, 768, 12, 64),
                           (False, 1, True, 0, False, 12386304, 31481856)),
    "SiT-base B=128": ((128, 1281, 1281, 768, 12, 64),
                       (False, 1, False, 528611328, False, 528611328, 125927424)),
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_attention_backward_route(name):
    """The resident backward at head dim 32 (every MS-SiT fold and edge:
    N <= 320, queries = keys), packing 64 // N sequences where N <= 32 (stage
    2's axial fold: 3 of 20 rows, 60 rows a tile); the few-query kernel for
    the CLS block's 8 queries against N keys; the streamed kernels at head
    dim 64 elsewhere."""
    (B, N, rows, _, heads, dh), (resident, pack, few, ws, _, _, _) = SHAPES[name]
    assert fa.resident_bwd(rows, N, dh) is resident
    assert fa.resident_pack(N) == pack
    assert fa.bwd_workspace_floats(B, heads, rows, N, dh) == ws
    assert not fa.resident_bwd(rows, N, dh, dropout=True)
    assert fa.few_query_bwd(rows, N, dh) is few
    assert not fa.few_query_bwd(rows, N, dh, dropout=True)


@pytest.mark.parametrize("name", list(SHAPES))
def test_layernorm_in_epilogue_route(name):
    """The LayerNorm backwards fold into dh's product at widths up to the
    GEMM engine's 192-column tile, whatever the head dim (MS-SiT stages 0-1,
    SiT-tiny); stages 2-3 and SiT-base run the standalone pass."""
    (_, _, _, dim, _, _), (_, _, _, _, fused, _, _) = SHAPES[name]
    assert fb.ln_in_epilogue(dim) is fused


@pytest.mark.parametrize("name", list(SHAPES))
def test_block_backward_workspace(name):
    """``svt_block_bwd_workspace``'s floats: the largest of the split-K and
    column partials, or the attention backward's dQ sums, which the
    resident and few-query kernels no longer need (the streamed kernels
    asked 503 M floats, 2 GB, at stage 0's window fold, and 12,585,984 for
    the SiT-tiny CLS block's 8 queries)."""
    (B, N, rows, dim, heads, dh), (_, _, _, ws, _, block_ws, _) = SHAPES[name]
    assert fb.block_bwd_workspace(B, N, rows, dim, heads, dh, 4 * dim) == block_ws
    assert block_ws >= ws


@pytest.mark.parametrize("name", list(SHAPES))
def test_block_backward_dh_scratch(name):
    """``svt_block_bwd_dh_floats``: the fp32 dh the chain writes, B * N *
    dim where a standalone LayerNorm backward reads it (dims past 192), else
    none: the CLS block at dim 192 too (N = 321), whose LN1 adds the top
    rows' dq W_q share in dkv W_kv's epilogue."""
    (B, N, rows, dim, _, _), (_, _, _, _, fused, _, dh_floats) = SHAPES[name]
    cls_rows = rows if rows < N else 0
    assert fb.block_bwd_dh_floats(B, N, dim, cls_rows) == dh_floats
    assert (dh_floats == 0) is fused


# The CLS block at SiT-tiny width (B = 256, dim 192, 3 heads, dh 64) by
# sequence length: N -> (LN1 in dkv W_kv's epilogue, dh scratch floats,
# block backward workspace floats). Under 16 rows a sample an epilogue
# thread's two rows, 8 apart, can both be top rows, so LN1 runs standalone
# on an fp32 dh of B * N * 192 floats. The workspace is the largest split-K
# partials (6 splits of 192 x 768 at N = 12), and at N = 8 the streamed
# attention's dQ sums; each holds the top rows' dq W_q share (2048 x 192 =
# 393,216 floats).
CLS_TINY = {
    8: (False, 393216, 12585984), 12: (False, 589824, 884736),
    15: (False, 737280, 1032192), 16: (True, 0, 1179648), 321: (True, 0, 3096576),
}


@pytest.mark.parametrize("N", list(CLS_TINY))
def test_cls_ln1_route(N):
    """``cls_ln1_in_epilogue`` and the CLS backward's dh scratch and
    workspace at SiT-tiny width, across the 16-row edge; N = 8 takes the
    streamed attention backward (8 queries against 8 keys), whose dQ sums
    set the workspace."""
    fused, dh_floats, block_ws = CLS_TINY[N]
    rows = min(8, N)
    assert fb.cls_ln1_in_epilogue(N, rows, 192) is fused
    assert fb.block_bwd_dh_floats(256, N, 192, rows) == dh_floats
    ws = fb.block_bwd_workspace(256, N, rows, 192, 3, 64, 768)
    assert ws == block_ws
    assert ws >= 256 * rows * 192 + (132 * 2 * 192 if fused else 0)
    assert not fb.cls_ln1_in_epilogue(N, rows, 384)


def test_cls_ln1_epilogue_invariant():
    """The rule holds exactly where the B_LN1_TOP epilogue's invariant does:
    of an epilogue thread's two rows (r with r % 16 < 8, and r + 8) at most
    one is a top row (r % N < rows, rows = min(8, N))."""
    for N in range(1, 65):
        rows = min(8, N)
        both = any(r % N < rows and (r + 8) % N < rows for r in range(64 * N) if r % 16 < 8)
        assert fb.cls_ln1_in_epilogue(N, rows, 192) is not both


def test_few_query_limits():
    """The few-query kernel's edges: every head dim up to 128 (32, 128 and
    20, in padded heads, too; 136 runs the wide kernels at these shapes), 1
    to 8 queries, more keys than 8; never with dropout."""
    assert fa.few_query_bwd(8, 9, 64) and fa.few_query_bwd(1, 1281, 64)
    assert not fa.few_query_bwd(9, 321, 64) and not fa.few_query_bwd(8, 8, 64)
    assert not fa.few_query_bwd(4, 4, 64) and fa.few_query_bwd(8, 321, 32)
    assert fa.few_query_bwd(8, 321, 128) and fa.few_query_bwd(8, 321, 20)
    assert not fa.few_query_bwd(8, 321, 136) and fa.wide_bwd(136) and not fa.wide_bwd(128)
    assert not fa.few_query_bwd(8, 321, 64, dropout=True)


def test_resident_limits():
    """The resident kernel's edges: 320 keys at most, queries = keys, head
    dim 32 only; a pack never overfills the 64-row tile."""
    assert fa.resident_bwd(320, 320, 32) and not fa.resident_bwd(321, 321, 32)
    assert not fa.resident_bwd(64, 80, 32) and not fa.resident_bwd(64, 64, 64)
    for n in range(1, 65):
        assert fa.resident_pack(n) * n <= 64
        assert fa.resident_pack(n) == (64 // n if n <= 32 else 1)
