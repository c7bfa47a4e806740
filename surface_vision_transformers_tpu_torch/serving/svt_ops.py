"""The four serving kernels as torch operators, for ``torch.export``.

``svt::patch_embed``, ``svt::fused_block``, ``svt::fused_block_cls`` and
``svt::fused_block_int8`` (the JAX package's ``pallas_patch_embed``,
``fused_block``, ``fused_block_cls`` and ``fused_block_int8``), each with a
schema, a fake (shape) function, which ``torch.export`` traces through, and a
CUDA kernel: the scratch the chain needs, the checks that need an address
(every TMA operand and float4 vector on 16 bytes; the embedding's tiling
asked of the library), the route rules asked of the C entries
(``svt_block_fused_mlp``, ``svt_cls_fwd_route``) and the ctypes call on the
current stream. On CUDA an operator runs the hand-written kernel or raises.

This file stands alone: it imports torch, ctypes and the standard library,
nothing of its package. A serving artifact carries a verbatim copy beside a
copy of the kernel library, so that an exported program runs where only
torch is installed (``bind(path)`` names the library; it is opened at the
first launch). The package binds its own build lazily and registers each
operator's CPU kernel as the plain version of its wrapper
(``ops/fused_block.py``, ``ops/fused_block_int8.py``, ``ops/patch_embed.py``),
so an exported graph holds the same ``svt::`` operators on either device.
Where a process has defined the operators already, importing another copy
keeps the first definition and its library.

``launches`` counts, by kernel name, every launch of an operator's chain,
and the kernels inside it it runs (``block_ln_gemm``, ``block_mlp``,
``few_query_fwd``, ``wide_fwd``); ``count_into`` adds them to other
counters too.

Head widths: the operators take the reference layout, heads of dim_head
columns. The kernels lay a head out in ``head_cols(dim_head)`` columns
(dim_head rounded up to 8, so that every head starts on 16 bytes), the
columns past dim_head zero: where they differ the CUDA kernels copy W_qkv
(and the int8 block's q_qkv and s_qkv) with zero rows and W_out (q_out)
with zero columns per head (``pad_heads``), the int8 block's q_out also
to a multiple of 16 columns, before the launch. A zero column adds nothing
to any score or product, and the chain takes the softmax scale of
dim_head, so the output is the unpadded block's.

Row widths: every dim and mlp >= 1. The kernels' tensor maps need rows of
16 bytes, so a width off 8 values (off 16 in the int8 block) is laid out
padded (``padded_width``), the columns past it zero, with the zero rows
and columns of the weights, LayerNorm parameters and biases that go with
them (``pad_dims``, ``pad_int8_dims``). The operators take ``ln_dim``, the
width the LayerNorms count: x's own width, or less where x and the
parameters come laid out padded (the models lay a stream out once; 0, the
default, means x's width). Given
x at a true width off the layout, the CUDA kernels copy it into a padded
buffer, pad the parameters and crop the output; the chains' LayerNorms
take their statistics over the first ln_dim columns, so every product and
residual is the unpadded block's.
"""

from __future__ import annotations

import collections
import ctypes

import torch

NAMESPACE = "svt"
_BLOCK = ("Tensor x, Tensor ln1_scale, Tensor ln1_bias, Tensor w_qkv, Tensor w_out, "
          "Tensor b_out, Tensor ln2_scale, Tensor ln2_bias, Tensor w_fc1, Tensor b_fc1, "
          "Tensor w_fc2, Tensor b_fc2")
_INT8 = ("Tensor x, Tensor ln1_scale, Tensor ln1_bias, Tensor q_qkv, Tensor s_qkv, "
         "Tensor q_out, Tensor s_out, Tensor b_out, Tensor ln2_scale, Tensor ln2_bias, "
         "Tensor q_fc1, Tensor s_fc1, Tensor b_fc1, Tensor q_fc2, Tensor s_fc2, Tensor b_fc2")
_INTS = "int heads, int dim_head, int valid_len, float ln_eps, int ln_dim=0"  # 0: x's width
SCHEMAS = {
    "patch_embed": "(Tensor x, Tensor indices, Tensor weight, Tensor bias) -> Tensor",
    "fused_block": f"({_BLOCK}, {_INTS}) -> Tensor",
    "fused_block_cls": f"({_BLOCK}, {_INTS}) -> Tensor",
    "fused_block_int8": f"({_INT8}, {_INTS}) -> Tensor",
}
CLS_ROWS = 8  # the CLS block's output rows a sample, min(8, N)
MAX_TILE_COLS = 128  # the widest wgmma tile; heads laid out wider run the wide kernels
GEMM_BN = 192  # csrc/gemm.cuh's BN: fc1's absmax partials, one a row and BN columns

launches: collections.Counter = collections.Counter()
_targets: dict = {}
_source = None  # the library's path, or a function that gives it
_lib = None


def bind(path) -> None:
    """Take the kernel library from ``path`` (a file, or a function that
    builds and returns one), opened at the next launch."""
    global _source, _lib
    _source, _lib = path, None


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the entries these operators call."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, args in (("svt_fused_block", [P] * 18 + [I] * 8 + [F, I, P]),
                       ("svt_fused_block_cls", [P] * 19 + [I] * 9 + [F, I, P]),
                       ("svt_fused_block_int8", [P] * 25 + [I] * 9 + [F, I, P]),
                       ("svt_patch_embed", [P, I] + [P] * 4 + [I] * 7 + [I, P]),
                       ("svt_patch_embed_smem", [I] * 5), ("svt_cls_fwd_route", [I] * 4),
                       ("svt_block_fused_mlp", [I] * 3), ("svt_error_string", [I])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_char_p if name == "svt_error_string" else I
    return lib


def library() -> ctypes.CDLL:
    """The bound kernel library, opened (and, where bound to a function,
    built) on first use."""
    global _lib
    if _lib is None:
        if _source is None:
            raise RuntimeError("no kernel library bound to the svt operators (svt_ops.bind)")
        _lib = declare(ctypes.CDLL(str(_source() if callable(_source) else _source)))
    return _lib


def check(err: int) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err:
        msg = library().svt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} (error {err})")


def count_into(**targets) -> None:
    """Also add each launch of kernel ``name`` to ``targets[name].launches``."""
    _targets.update(targets)


def _launched(*names: str) -> None:
    for n in names:
        launches[n] += 1
        if n in _targets:
            _targets[n].launches += 1


def _on_16(what: str, *tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary (TMA and float4 loads)")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def head_cols(dh: int) -> int:
    """Columns a head of dh columns is laid out in on the card: dh rounded
    up to 8 (``csrc/flash_attention.cuh``)."""
    return -(-dh // 8) * 8


def int8_cols(hd: int) -> int:
    """Columns of the int8 block's attention-output rows (and q_out's K)
    for an inner width hd: hd rounded up to 16, the int8 rows' 16 bytes."""
    return -(-hd // 16) * 16


def pad_heads(t: torch.Tensor, groups: int, dh: int, dim: int) -> torch.Tensor:
    """t with each of the ``groups`` runs of dh entries along dimension
    ``dim`` (heads, or q / k / v heads) padded with zeros to
    ``head_cols(dh)``, contiguous; t itself where dh is a multiple of 8."""
    dp = head_cols(dh)
    if dp == dh:
        return t
    v = t.unflatten(dim, (groups, dh))
    pad = (0, 0) * (v.dim() - dim - 2) + (0, dp - dh)
    return torch.nn.functional.pad(v, pad).flatten(dim, dim + 1).contiguous()


def crop_heads(t: torch.Tensor, groups: int, dh: int, dim: int) -> torch.Tensor:
    """``pad_heads`` undone: the first dh of each run of ``head_cols(dh)``
    along ``dim``."""
    dp = head_cols(dh)
    if dp == dh:
        return t
    return t.unflatten(dim, (groups, dp)).narrow(dim + 1, 0, dh).flatten(dim, dim + 1)


ROW_ALIGN, INT8_ROW_ALIGN = 8, 16  # values a row: 16 bytes of bf16, of int8


def padded_width(n: int, align: int = ROW_ALIGN) -> int:
    """The columns a row of n values is laid out in: n rounded up to
    ``align``."""
    return -(-n // align) * align


def pad_to(t: torch.Tensor, shape) -> torch.Tensor:
    """t with zeros appended along each dimension up to ``shape`` (a
    differentiable copy); t itself where it has that shape."""
    if tuple(t.shape) == tuple(shape):
        return t
    pad = []
    for have, want in zip(reversed(t.shape), reversed(tuple(shape))):
        pad += [0, want - have]
    return torch.nn.functional.pad(t, pad)


def crop_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``pad_to`` undone: the leading ``shape`` block of t."""
    if tuple(t.shape) == tuple(shape):
        return t
    return t[tuple(slice(0, n) for n in shape)]


def pad_dims(params, dim: int, mlp: int) -> list:
    """The bf16 block's 11 parameters (torch layout) laid out for rows of
    ``dim`` columns and a hidden width of ``mlp``, zeros appended: the
    LayerNorm parameters, b_out and b_fc2 to dim, W_qkv's columns and
    W_out's rows to dim, W_fc1 to (mlp, dim), b_fc1 to mlp, W_fc2 to (dim,
    mlp). No copy where they have those widths."""
    ln1_s, ln1_b, w_qkv, w_out, b_out, ln2_s, ln2_b, w_fc1, b_fc1, w_fc2, b_fc2 = params
    v = (dim,)
    return [pad_to(ln1_s, v), pad_to(ln1_b, v), pad_to(w_qkv, (w_qkv.shape[0], dim)),
            pad_to(w_out, (dim, w_out.shape[1])), pad_to(b_out, v), pad_to(ln2_s, v),
            pad_to(ln2_b, v), pad_to(w_fc1, (mlp, dim)), pad_to(b_fc1, (mlp,)),
            pad_to(w_fc2, (dim, mlp)), pad_to(b_fc2, v)]


def pad_int8_dims(params, dim: int, mlp: int) -> list:
    """``pad_dims`` for the int8 block's 15 parameters: the codes as the
    matrices, the scales of the padded output channels 0."""
    (ln1_s, ln1_b, q_qkv, s_qkv, q_out, s_out, b_out, ln2_s, ln2_b,
     q_fc1, s_fc1, b_fc1, q_fc2, s_fc2, b_fc2) = params
    v = (dim,)
    return [pad_to(ln1_s, v), pad_to(ln1_b, v), pad_to(q_qkv, (q_qkv.shape[0], dim)), s_qkv,
            pad_to(q_out, (dim, q_out.shape[1])), pad_to(s_out, v), pad_to(b_out, v),
            pad_to(ln2_s, v), pad_to(ln2_b, v), pad_to(q_fc1, (mlp, dim)),
            pad_to(s_fc1, (mlp,)), pad_to(b_fc1, (mlp,)), pad_to(q_fc2, (dim, mlp)),
            pad_to(s_fc2, v), pad_to(b_fc2, v)]


def laid_out(x, params, mlp_at: int, align: int, pad):
    """x (B, N, width) and a block's parameters as a chain takes them:
    -> (x, params, width) with x's width and the hidden width rounded up to
    ``align`` (x copied and the parameters padded where they are off it)."""
    B, N, width = x.shape
    dp = padded_width(width, align)
    mp = padded_width(params[mlp_at].shape[0], align)
    return pad_to(x, (B, N, dp)).contiguous(), [t.contiguous() for t in pad(params, dp, mp)], \
        width


def pad_block(params, heads: int, dim_head: int) -> list:
    """The bf16 block's 11 parameters as the kernels take them: W_qkv's rows
    and W_out's columns laid out per head in ``head_cols(dim_head)``."""
    p = list(params)
    p[2] = pad_heads(p[2], 3 * heads, dim_head, 0)
    p[3] = pad_heads(p[3], heads, dim_head, 1)
    return p


def pad_int8_block(params, heads: int, dim_head: int) -> list:
    """The int8 block's 15 parameters as its chain takes them: q_qkv's rows
    and s_qkv laid out per head in ``head_cols(dim_head)`` (zero codes and
    scales), q_out's columns per head and then to ``int8_cols`` (zero
    codes)."""
    p = list(params)
    p[2] = pad_heads(p[2], 3 * heads, dim_head, 0)
    p[3] = pad_heads(p[3], 3 * heads, dim_head, 0)
    q_out = pad_heads(p[4], heads, dim_head, 1)
    hd = q_out.shape[1]
    if int8_cols(hd) != hd:
        q_out = torch.nn.functional.pad(q_out, (0, int8_cols(hd) - hd))
    p[4] = q_out
    return p


def int8_workspace(M: int, dim: int, hd: int, mlp: int) -> dict:
    """The int8 chain's scratch for M rows at inner width hd (heads x
    ``head_cols``) -> name: (shape, dtype), in the C entry's order: the int8
    rows of LN1, the attention output (``int8_cols(hd)`` bytes) and LN2
    (qa, sa), f's codes and scales (qf, sf), fc1's absmax partials (part),
    qkv and the attention output in bfloat16, x1 in float32. No (M, mlp)
    float32 f."""
    i8, f32, b16 = torch.int8, torch.float32, torch.bfloat16
    hq = int8_cols(hd)
    return {"qa": ((M, max(dim, hq)), i8), "sa": ((M,), f32), "qf": ((M, mlp), i8),
            "sf": ((M,), f32), "part": ((-(-mlp // GEMM_BN), M), f32),
            "qkv": ((M, 3 * hd), b16), "attn": ((M, hq), b16), "x1": ((M, dim), f32)}


def _wide(dim_head: int) -> tuple:
    """('wide_fwd',) where the chain's attention runs the wide kernels."""
    return ("wide_fwd",) if head_cols(dim_head) > MAX_TILE_COLS else ()


def block_args(x, args) -> tuple:
    """A block operator's arguments after x -> (the parameters, heads,
    dim_head, valid_len, ln_eps, ln_dim), ln_dim x's width where the caller
    left it out or gave 0 (the dispatcher passes only the arguments given)."""
    n = next(i for i, a in enumerate(args) if not isinstance(a, torch.Tensor))
    heads, dim_head, valid_len, ln_eps, *rest = args[n:]
    return list(args[:n]), heads, dim_head, valid_len, ln_eps, (rest[0] if rest else 0) or \
        x.shape[-1]


# -- CUDA kernels ---------------------------------------------------------------------


def _patch_embed_cuda(x, indices, weight, bias):
    B, C, G = x.shape
    L, V = indices.shape
    width, kp = weight.shape
    dim = padded_width(width)  # a width off 8: W's rows and the bias padded, the output cropped
    weight, bias = pad_to(weight, (dim, kp)).contiguous(), pad_to(bias, (dim,)).contiguous()
    _on_16("the patch-embed weight", weight)
    lib = library()
    if lib.svt_patch_embed_smem(L, V, C, kp, dim) == 0:
        raise NotImplementedError(
            f"the kernel does not take C {C} channels, or its tiles at V {V}, Kp {kp}, dim "
            f"{dim} leave no room for its A ring in an H100 block's shared memory "
            "(svt_patch_embed_smem)")
    out = torch.empty((B, L, dim), dtype=weight.dtype, device=x.device)
    check(lib.svt_patch_embed(
        x.data_ptr(), int(x.dtype == torch.float32), indices.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), out.data_ptr(), B, C, G, L, V, kp, dim, x.device.index, _stream(x)))
    _launched("patch_embed")
    return crop_to(out, (B, L, width)).contiguous()


def _fused_block_cuda(x, *args):
    params, heads, dim_head, valid_len, ln_eps, ln_dim = block_args(x, args)
    x, params, width = laid_out(x, params, 7, ROW_ALIGN, pad_dims)
    params = pad_block(params, heads, dim_head)
    _on_16("the block kernels' operands and vectors", x, *params)
    lib = library()
    B, N, dim = x.shape
    hd, mlp, M = heads * head_cols(dim_head), params[7].shape[0], B * N
    fused = ln_dim == dim and bool(lib.svt_block_fused_mlp(dim, mlp, 0))
    out = torch.empty_like(x)
    unused = x.new_empty(8)  # h and f: never touched where the chain fuses the MLP
    ws = [unused if fused else x.new_empty((M, dim)), x.new_empty((M, 3 * hd)),
          x.new_empty((M, hd)), x.new_empty((M, dim)),
          unused if fused else x.new_empty((M, mlp))]
    check(lib.svt_fused_block(*[t.data_ptr() for t in (x, *params, out, *ws)],
                              B, N, dim, ln_dim, heads, dim_head, mlp, valid_len, ln_eps,
                              x.device.index, _stream(x)))
    _launched("fused_block", *(("block_ln_gemm", "block_mlp") if fused else ()),
              *_wide(dim_head))
    return crop_to(out, (B, N, width)).contiguous()


def _fused_block_cls_cuda(x, *args):
    params, heads, dim_head, valid_len, ln_eps, ln_dim = block_args(x, args)
    x, params, width = laid_out(x, params, 7, ROW_ALIGN, pad_dims)
    params = pad_block(params, heads, dim_head)
    _on_16("the block kernels' operands and vectors", x, *params)
    lib = library()
    B, N, dim = x.shape
    rows = min(CLS_ROWS, N)
    hd, mlp, Mt = heads * head_cols(dim_head), params[7].shape[0], B * rows
    # bit 1: few-query attention; 2: LN1 in K/V (and Q made in the attention)
    route = lib.svt_cls_fwd_route(N, rows, dim, dim_head)
    ln_kv = ln_dim == dim and bool(route & 2)
    out = x.new_empty((B, rows, dim))
    # where LN1 runs in the K/V product, h is LN2's output alone and q is
    # made in the attention's CTAs
    ws = [x.new_empty((Mt if ln_kv else B * N, dim)), x.new_empty((B * N, 2 * hd)),
          x.new_empty(8 if ln_kv else (Mt, hd)), x.new_empty((Mt, hd)), x.new_empty((Mt, dim)),
          x.new_empty((Mt, mlp))]
    check(lib.svt_fused_block_cls(*[t.data_ptr() for t in (x, *params, out, *ws)],
                                  B, N, rows, dim, ln_dim, heads, dim_head, mlp, valid_len,
                                  ln_eps, x.device.index, _stream(x)))
    _launched("fused_block_cls", *(("few_query_fwd",) if route & 1 else ()),
              *(("block_ln_gemm",) if ln_kv else ()), *_wide(dim_head))
    return crop_to(out, (B, rows, width)).contiguous()


def _fused_block_int8_cuda(x, *args):
    params, heads, dim_head, valid_len, ln_eps, ln_dim = block_args(x, args)
    x, params, width = laid_out(x, params, 9, INT8_ROW_ALIGN, pad_int8_dims)
    params = pad_int8_block(params, heads, dim_head)
    _on_16("the int8 block's operands, scales and vectors", x, *params)
    B, N, dim = x.shape
    hd, mlp, M = heads * head_cols(dim_head), params[9].shape[0], B * N
    out = torch.empty_like(x)
    spec = int8_workspace(M, dim, hd, mlp)
    ws = [torch.empty(shape, dtype=dt, device=x.device) for shape, dt in spec.values()]
    check(library().svt_fused_block_int8(
        *[t.data_ptr() for t in (x, *params, out, *ws)],
        B, N, dim, ln_dim, heads, dim_head, mlp, spec["part"][0][0], valid_len, ln_eps,
        x.device.index, _stream(x)))
    _launched("fused_block_int8", *_wide(dim_head))
    return crop_to(out, (B, N, width)).contiguous()


# -- fake (shape) functions -------------------------------------------------------------


def _patch_embed_fake(x, indices, weight, bias):
    return x.new_empty((x.shape[0], indices.shape[0], weight.shape[0]), dtype=weight.dtype)


def _same_shape_fake(x, *args):
    return torch.empty_like(x)


def _cls_fake(x, *args):
    return x.new_empty((x.shape[0], min(CLS_ROWS, x.shape[1]), x.shape[2]))


KERNELS = {"patch_embed": (_patch_embed_cuda, _patch_embed_fake),
           "fused_block": (_fused_block_cuda, _same_shape_fake),
           "fused_block_cls": (_fused_block_cls_cuda, _cls_fake),
           "fused_block_int8": (_fused_block_int8_cuda, _same_shape_fake)}


def _defined() -> bool:
    try:
        getattr(torch.ops, NAMESPACE).fused_block
    except (AttributeError, RuntimeError):
        return False
    return True


if not _defined():
    _LIB = torch.library.Library(NAMESPACE, "DEF")
    for _name, (_cuda, _fake) in KERNELS.items():
        _LIB.define(_name + SCHEMAS[_name])
        _LIB.impl(_name, _cuda, "CUDA")
        torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)
