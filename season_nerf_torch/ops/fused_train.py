"""The fused training trunk: ghost BatchNorm, K1 and K2, and their glue.

The counterpart of ``season_nerf_tpu/ops/pallas_train.py``.  The trunk
fc1..fcN + fc9 and the packed sigma/color heads run as one differentiable
function of the PE and the packed parameters:

- omega (30) is folded into the packed weights and biases;
- the skip layer reads ``[h | PE]`` as two products over its weight rows;
- BatchNorm on every layer but the first normalises with the mean and the
  biased variance of each ``tile`` rows ("ghost" BatchNorm), computed in
  two passes (mean, then mean((z - mu)^2));
- the activation is the polynomial sine (or sin), stored in ``act_dtype``;
- the heads are one ``[enc, 8]`` product (col 0 sigma_raw, 1:4 col_raw).

K1 (:func:`trunk_fwd`, ``csrc/trunk_train_fwd.cu``) computes the outputs
and the sums over tiles of the per-tile statistics; K2 (:func:`trunk_bwd`,
``csrc/trunk_train_bwd.cu``) recomputes the forward and returns the f32
gradient of every packed parameter.  Each wrapper runs its plain version
(:func:`trunk_fwd_reference`, :func:`trunk_bwd_reference`) for a CPU
tensor, launches its kernel for a CUDA tensor or raises, and counts its
launches as ``k1.launches`` and ``k2.launches`` (``utils/trace``; each
launch is the span ``k1.launch`` or ``k2.launch``).  :class:`TrunkTrain`
joins the two as an autograd function; :func:`fused_forward` and
:func:`fused_forward_solar` are the network forwards the training step
calls with a spec.  The bf16
GEMM inside both (TMA + ``wgmma``) is bound alone as :func:`gemm_bf16`, for
tests and measurements; on the card it needs every width and ``pe_dim`` to
be a multiple of 8 (:func:`check_card_widths`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from season_nerf_torch.models.encodings import positional_encode
from season_nerf_torch.models.siren import BN_EPS
from season_nerf_torch.ops.cuda_build import Library
from season_nerf_torch.ops.fast_math import plain_cos, plain_sin
from season_nerf_torch.ops.fused_trunk import trunk_layers
from season_nerf_torch.utils import trace

OMEGA = 30.0
PE_PAD = 64          # padded extended-PE width (63 -> 64)
HEAD_PAD = 8         # sigma (1) + color (3) + 4 zero columns
FWD_KERNEL = "trunk_train_fwd"
BWD_KERNEL = "trunk_train_bwd"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FWD_LIB = Library(FWD_KERNEL, {
    "trunk_train_fwd_launch": (_P, _I, _P, _I, _I, _I, _P, _P, _I, _P, _P,
                               _I, _I, _I, _P),
    "trunk_train_gemm_launch": (_P, _I, _L, _P, _I, _L, _P, _L, _P, _I, _I,
                                _I, _I, _I, _P, _L, _P)})
BWD_LIB = Library(BWD_KERNEL, {
    "trunk_train_bwd_launch": (_P, _I, _P, _I, _I, _I, _P, _I, _P, _P, _P,
                               _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _L,
                               _P)})
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TrunkSpec:
    """Static structure of the trunk.  ``widths[i]`` is layer i's output
    width; layer 0 reads the PE, the skip layer ``[h | PE]``; every layer
    but the first has BatchNorm.  ``grad_dtype`` is the type of the
    backward products' gradient operand, ``act_dtype`` that of the stored
    activations (bf16 in training, f32 for tight tests)."""
    widths: Tuple[int, ...] = (512,) * 8 + (256,)
    skip_idx: int = 4
    pe_dim: int = PE_PAD
    tile: int = 2048
    fast_sine: bool = True
    grad_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"

    @property
    def n_layers(self):
        return len(self.widths)

    @property
    def has_bn(self):
        return tuple(i > 0 for i in range(self.n_layers))

    @property
    def in_dims(self):
        return tuple(self.pe_dim if i == 0 else
                     self.widths[i - 1] + (self.pe_dim if i == self.skip_idx
                                           else 0)
                     for i in range(self.n_layers))

    @property
    def enc_width(self):
        return self.widths[-1]

    @property
    def stat_width(self):
        return max(self.widths)

    @property
    def n_bn(self):
        return sum(self.has_bn)

    def is_skip(self, i):
        return i == self.skip_idx and i > 0

    def offsets(self) -> List[int]:
        """Index in the packed list of each layer's weight; the heads'
        ``wh, bh`` come last."""
        out, k = [], 0
        for i in range(self.n_layers):
            out.append(k)
            k += 4 if self.has_bn[i] else 2
        return out

    @property
    def n_params(self):
        return 2 * self.n_layers + 2 * self.n_bn + 2


# --- packing --------------------------------------------------------------
def pack_params(gnerf, spec: TrunkSpec) -> List[torch.Tensor]:
    """A ``GNeRF``'s trunk and heads as the packed f32 list, differentiable:
    per layer ``W [in, out]`` (omega folded in, the PE rows zero-padded), ``b
    [1, out]`` (omega folded in), then ``gamma, beta [1, out]`` for a BN
    layer; then ``wh [enc, 8]`` and ``bh [1, 8]``.  Weights stay f32 here:
    :class:`TrunkTrain` casts them to bf16, so that their gradients reach
    the parameters unrounded."""
    out = []
    for i, (layer, _) in enumerate(trunk_layers(gnerf)):
        W = OMEGA * layer.linear.weight.t()
        if W.shape[0] != spec.in_dims[i]:
            W = F.pad(W, (0, 0, 0, spec.in_dims[i] - W.shape[0]))
        out += [W, (OMEGA * layer.linear.bias)[None, :]]
        if spec.has_bn[i]:
            out += [layer.norm.weight[None, :], layer.norm.bias[None, :]]
    ws, wc = gnerf.fc10Sigma.weight.t(), gnerf.fc10Col.weight.t()
    zeros = ws.new_zeros((spec.enc_width, HEAD_PAD - 4))
    out.append(torch.cat([ws, wc, zeros], 1))
    out.append(torch.cat([gnerf.fc10Sigma.bias, gnerf.fc10Col.bias,
                          zeros[0]])[None, :])
    return [t.float() for t in out]


def kernel_params(spec: TrunkSpec, packed: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """The packed list in the kernels' types: weights (and ``wh``) bf16,
    everything else f32, all contiguous."""
    weights = set(spec.offsets()) | {spec.n_params - 2}
    return [(p.to(torch.bfloat16) if i in weights else p.float())
            .contiguous() for i, p in enumerate(packed)]


def unpack_head_grads(d_wh, d_bh):
    """[enc, 8] / [1, 8] head gradients -> (dW_sigma, db_sigma, dW_col,
    db_col) with the heads' own shapes ([in, out] layout)."""
    return d_wh[:, 0:1], d_bh[0, 0:1], d_wh[:, 1:4], d_bh[0, 1:4]


def encode_pe(x: torch.Tensor) -> torch.Tensor:
    """[N, 3] points -> [N, 64] bf16 zero-padded extended PE (the kernels'
    input layout; the pad column meets fc1's zero row)."""
    pe = positional_encode(x.float(), 10, True).to(torch.bfloat16)
    return F.pad(pe, (0, PE_PAD - pe.shape[-1])).contiguous()


# --- plain versions ---------------------------------------------------------
def _mm(a, b):
    """f32 product of operands in any type (bf16 x bf16 is exact in f32)."""
    return a.float() @ b.float()


def _forward_tiles(spec: TrunkSpec, pe, params):
    """The trunk over all tiles at once; -> (xenc, heads, mus, vars, layer
    inputs, per-layer (zh, var) with var [n_tiles, 1, w] or None)."""
    n, T = pe.shape[0], spec.tile
    nt = n // T
    sin = plain_sin if spec.fast_sine else torch.sin
    act = _DTYPES[spec.act_dtype]
    offs = spec.offsets()
    h = pe
    mus, var_list, inputs, zhs = [], [], [], []
    for i in range(spec.n_layers):
        w, b = params[offs[i]], params[offs[i] + 1]
        if spec.is_skip(i):
            lw = spec.widths[i - 1]
            z = _mm(h, w[:lw]) + _mm(pe, w[lw:])
        else:
            z = _mm(h, w)
        z = z + b
        inputs.append(h)
        if spec.has_bn[i]:
            g, be = params[offs[i] + 2], params[offs[i] + 3]
            zt = z.reshape(nt, T, -1)
            mu = zt.mean(1, keepdim=True)
            zc = zt - mu
            var = (zc * zc).mean(1, keepdim=True)
            zh = zc * torch.rsqrt(var + BN_EPS)
            y = (g * zh + be).reshape(n, -1)
            mus.append(mu[:, 0])
            var_list.append(var[:, 0])
            zhs.append((zh.reshape(n, -1), var))
        else:
            y = z
            zhs.append((z, None))
        h = sin(y).to(act)
    heads = _mm(h, params[-2]) + params[-1]
    return h, heads, mus, var_list, inputs, zhs


def _stats(spec: TrunkSpec, mus, var_list) -> torch.Tensor:
    """[2 n_bn, stat_width]: the sums over tiles of each BN layer's tile
    means, then of its tile variances, zero-padded to ``stat_width``."""
    rows = [F.pad(m.sum(0), (0, spec.stat_width - m.shape[1]))
            for m in mus + var_list]
    return torch.stack(rows)


@torch.no_grad()
def trunk_fwd_reference(spec: TrunkSpec, pe: torch.Tensor,
                        params: Sequence[torch.Tensor]):
    """The plain version of K1: (pe [N, pe_dim] bf16, kernel params) ->
    (xenc [N, enc] act_dtype, heads [N, 8] f32, stats [2 n_bn, stat_width]
    f32, sums over tiles)."""
    xenc, heads, mus, var_list, _, _ = _forward_tiles(spec, pe, params)
    return xenc, heads, _stats(spec, mus, var_list)


@torch.no_grad()
def trunk_bwd_reference(spec: TrunkSpec, pe: torch.Tensor,
                        params: Sequence[torch.Tensor],
                        d_xenc: torch.Tensor, d_heads: torch.Tensor
                        ) -> List[torch.Tensor]:
    """The plain version of K2: the gradients (f32, the params' shapes) of
    ``sum(xenc * d_xenc) + sum(heads * d_heads)``, by the math of
    ``pallas_train.py::_bwd_kernel``: the forward recomputed, then the
    heads, cos for the sine, the ghost-BN backward per tile, and products
    whose gradient operand is ``grad_dtype``."""
    n, T = pe.shape[0], spec.tile
    nt = n // T
    cos = plain_cos if spec.fast_sine else torch.cos
    gd = _DTYPES[spec.grad_dtype]
    offs = spec.offsets()
    xenc, _, _, _, inputs, zhs = _forward_tiles(spec, pe, params)
    tile_sum = lambda a: a.reshape(nt, T, -1).sum(1).sum(0, keepdim=True)
    grads: List[Optional[torch.Tensor]] = [None] * len(params)
    d_heads = d_heads.float()
    grads[-2] = _mm(xenc.t(), d_heads)
    grads[-1] = tile_sum(d_heads)
    da = d_xenc.float() + _mm(d_heads.to(gd), params[-2].t())
    for li in range(spec.n_layers - 1, -1, -1):
        o = offs[li]
        zh, var = zhs[li]
        if spec.has_bn[li]:
            g, be = params[o + 2], params[o + 3]
            dy = da * cos(g * zh + be)
            grads[o + 2] = tile_sum(dy * zh)
            grads[o + 3] = tile_sum(dy)
            dzh = (dy * g).reshape(nt, T, -1)
            zht = zh.reshape(nt, T, -1)
            m1 = dzh.mean(1, keepdim=True)
            m2 = (dzh * zht).mean(1, keepdim=True)
            dz = (torch.rsqrt(var + BN_EPS) * (dzh - m1 - zht * m2)
                  ).reshape(n, -1)
        else:
            dz = da * cos(zh)
        grads[o + 1] = tile_sum(dz)
        dzb = dz.to(gd)
        w = params[o]
        if spec.is_skip(li):
            lw = spec.widths[li - 1]
            grads[o] = torch.cat([_mm(inputs[li].t(), dzb),
                                  _mm(pe.t(), dzb)], 0)
            da = _mm(dzb, w[:lw].t())
        else:
            grads[o] = _mm(inputs[li].t(), dzb)
            if li > 0:
                da = _mm(dzb, w.t())
    return grads


# --- the kernels' wrappers --------------------------------------------------
def check_card_widths(spec: TrunkSpec, name: str):
    """The kernels' GEMM loads its bf16 operands with TMA, which wants
    16-byte row strides: on the card every width and ``pe_dim`` is a
    multiple of 8 (the plain versions take any)."""
    bad = [w for w in spec.widths + (spec.pe_dim,) if w % 8]
    if bad:
        raise ValueError(f"{name}: widths {spec.widths} and pe_dim "
                         f"{spec.pe_dim} must be multiples of 8 on the card "
                         f"(got {bad})")


def _check(spec: TrunkSpec, pe: torch.Tensor, params, name: str):
    if pe.device.type != "cuda":
        raise ValueError(f"{name} takes a cpu or cuda tensor, got "
                         f"{pe.device}")
    check_card_widths(spec, name)
    n = pe.shape[0] if pe.dim() == 2 else -1
    if pe.dtype != torch.bfloat16 or pe.dim() != 2 \
            or pe.shape[1] != spec.pe_dim or not pe.is_contiguous():
        raise ValueError(f"{name} takes a contiguous [N, {spec.pe_dim}] "
                         f"bf16 PE, got {tuple(pe.shape)} {pe.dtype}")
    if n <= 0 or n % spec.tile != 0 or n >= 2 ** 31:
        raise ValueError(f"{name}: {n} rows is not a positive multiple of "
                         f"the tile {spec.tile} below 2^31")
    if len(params) != spec.n_params:
        raise ValueError(f"{name}: {len(params)} params, the spec has "
                         f"{spec.n_params}")
    want = []
    for i in range(spec.n_layers):
        want.append((torch.bfloat16, (spec.in_dims[i], spec.widths[i])))
        want += [(torch.float32, (1, spec.widths[i]))] * (
            3 if spec.has_bn[i] else 1)
    want += [(torch.bfloat16, (spec.enc_width, HEAD_PAD)),
             (torch.float32, (1, HEAD_PAD))]
    for k, (p, (dt, shape)) in enumerate(zip(params, want)):
        if p.dtype != dt or tuple(p.shape) != shape \
                or p.device != pe.device or not p.is_contiguous():
            raise ValueError(f"{name}: param {k} is {tuple(p.shape)} "
                             f"{p.dtype} on {p.device}, want contiguous "
                             f"{shape} {dt} on {pe.device}")


_FIELDS = 16


def _table(spec: TrunkSpec, params, acts, zs, mus, vars_, save_zh,
           grads=None) -> np.ndarray:
    """The int64 layer table of ``csrc/trunk_train_common.cuh`` (host)."""
    offs = spec.offsets()
    rows = np.zeros((spec.n_layers, _FIELDS), np.int64)
    ptr = lambda t: t.data_ptr() if t is not None else 0
    for i in range(spec.n_layers):
        o, bn = offs[i], spec.has_bn[i]
        kind = 0 if i == 0 else 2 if spec.is_skip(i) else 1
        rows[i, :12] = [ptr(params[o]), ptr(params[o + 1]),
                        ptr(params[o + 2]) if bn else 0,
                        ptr(params[o + 3]) if bn else 0,
                        spec.in_dims[i], spec.widths[i], kind,
                        ptr(acts[i]), ptr(zs[i]), ptr(mus[i]),
                        ptr(vars_[i]), int(save_zh)]
        if grads is not None:
            rows[i, 12:] = [ptr(grads[o]), ptr(grads[o + 1]),
                            ptr(grads[o + 2]) if bn else 0,
                            ptr(grads[o + 3]) if bn else 0]
    return rows


def _per_tile(spec, n, device):
    nt = n // spec.tile
    return ([None] + [torch.empty((nt, w), device=device)
                      for w in spec.widths[1:]],
            [None] + [torch.empty((nt, w), device=device)
                      for w in spec.widths[1:]])


def trunk_fwd(spec: TrunkSpec, pe: torch.Tensor,
              params: Sequence[torch.Tensor]):
    """K1: (pe [N, pe_dim] bf16, kernel params) -> (xenc [N, enc]
    act_dtype, heads [N, 8] f32, stats [2 n_bn, stat_width] f32).

    CPU tensor: the plain version.  CUDA tensor: ``csrc/trunk_train_fwd.cu``
    on the current stream, or an error."""
    if pe.device.type == "cpu":
        return trunk_fwd_reference(spec, pe, params)
    _check(spec, pe, params, "trunk_fwd")
    dev, n = pe.device, pe.shape[0]
    act = _DTYPES[spec.act_dtype]
    # ping-pong activations; the last layer writes x_enc, its own buffer
    wmax = max(spec.widths)
    bufs = [torch.empty((n * wmax,), dtype=act, device=dev)
            for _ in range(2)]
    xenc = torch.empty((n, spec.enc_width), dtype=act, device=dev)
    acts = [bufs[i % 2] for i in range(spec.n_layers - 1)] + [xenc]
    z = torch.empty((n * wmax,), device=dev)
    mus, vars_ = _per_tile(spec, n, dev)
    heads = torch.empty((n, HEAD_PAD), device=dev)
    stats = torch.empty((2 * spec.n_bn, spec.stat_width), device=dev)
    table = _table(spec, params, acts, [z] * spec.n_layers, mus, vars_,
                   False)
    with trace.span("k1.launch"):
        FWD_LIB.launch(
            "trunk_train_fwd_launch", dev, table.ctypes.data, spec.n_layers,
            pe, spec.pe_dim, n, spec.tile, params[-2], params[-1], HEAD_PAD,
            heads, stats, spec.stat_width, int(act == torch.bfloat16),
            int(spec.fast_sine), counter="k1.launches", context=spec)
    return xenc, heads, stats


_MAX_SPLITS = 64      # kMaxSplits of trunk_train_common.cuh


def trunk_bwd(spec: TrunkSpec, pe: torch.Tensor,
              params: Sequence[torch.Tensor], d_xenc: torch.Tensor,
              d_heads: torch.Tensor) -> List[torch.Tensor]:
    """K2: the f32 gradient of every kernel param (the params' shapes) for
    the cotangents ``d_xenc [N, enc]`` (cast to ``grad_dtype``) and
    ``d_heads [N, 8]`` (f32).

    CPU tensor: the plain version.  CUDA tensor: ``csrc/trunk_train_bwd.cu``
    on the current stream, or an error."""
    gd = _DTYPES[spec.grad_dtype]
    d_xenc = d_xenc.to(gd).contiguous()
    d_heads = d_heads.float().contiguous()
    if pe.device.type == "cpu":
        return trunk_bwd_reference(spec, pe, params, d_xenc, d_heads)
    _check(spec, pe, params, "trunk_bwd")
    dev, n = pe.device, pe.shape[0]
    if tuple(d_xenc.shape) != (n, spec.enc_width) or d_xenc.device != dev \
            or tuple(d_heads.shape) != (n, HEAD_PAD) \
            or d_heads.device != dev:
        raise ValueError(f"trunk_bwd: cotangents {tuple(d_xenc.shape)}, "
                         f"{tuple(d_heads.shape)} do not fit {n} rows")
    act = _DTYPES[spec.act_dtype]
    wmax = max(spec.widths)
    # every layer's output (the next layer's input) and f32 zh, kept
    acts = [torch.empty((n, w), dtype=act, device=dev) for w in spec.widths]
    zs = [torch.empty((n, w), device=dev) for w in spec.widths]
    mus, vars_ = _per_tile(spec, n, dev)
    grads = [torch.empty(p.shape, device=dev) for p in params]
    da = torch.empty((n * wmax,), device=dev)
    dz = torch.empty((n * wmax,), dtype=gd, device=dev)
    dheads_g = torch.empty((n, HEAD_PAD), dtype=gd, device=dev)
    part_w = max(wmax, HEAD_PAD)
    part = torch.empty((3, n // spec.tile, part_w), device=dev)
    ws_floats = _MAX_SPLITS * max(k * w for k, w in
                                  zip(spec.in_dims + (spec.enc_width,),
                                      spec.widths + (HEAD_PAD,)))
    ws = torch.empty((ws_floats,), device=dev)
    table = _table(spec, params, acts, zs, mus, vars_, True, grads)
    with trace.span("k2.launch"):
        BWD_LIB.launch(
            "trunk_train_bwd_launch", dev, table.ctypes.data, spec.n_layers,
            pe, spec.pe_dim, n, spec.tile, params[-2], HEAD_PAD, d_xenc,
            d_heads, grads[-2], grads[-1], int(act == torch.bfloat16),
            int(gd == torch.bfloat16), int(spec.fast_sine), da, dz, dheads_g,
            part, part_w, ws, ws_floats, counter="k2.launches", context=spec)
    return grads


# --- the GEMM of K1 and K2, alone ------------------------------------------
# layout -> (A is K-major, B is K-major), as the kernels call it: the
# forward z = h . W (W [K, N]), the input gradient da = dz . W^T (W [N, K])
# and the weight gradient dW = h^T . dz over the rows
GEMM_LAYOUTS = {"fwd": (True, False), "dgrad": (True, True),
                "wgrad": (False, False)}


def gemm_operands(a: torch.Tensor, b: torch.Tensor, layout: str):
    """(A [M, K], B [K, N]) views of the stored operands of ``layout``."""
    a_kc, b_kc = GEMM_LAYOUTS[layout]
    return (a if a_kc else a.t()), (b.t() if b_kc else b)


def gemm_reference(a, b, layout, bias=None, c=None):
    """The plain version of :func:`gemm_bf16`, into a new tensor: the f32
    product of the bf16 operands (exact products, f32 sums), ``c +`` it,
    then ``+ bias``."""
    A, B = gemm_operands(a, b, layout)
    out = _mm(A, B)
    if c is not None:
        out = c.float() + out
    if bias is not None:
        out = out + bias.float()
    return out


def gemm_bf16(a: torch.Tensor, b: torch.Tensor, layout: str,
              bias: Optional[torch.Tensor] = None,
              c: Optional[torch.Tensor] = None,
              split: bool = False) -> torch.Tensor:
    """The bf16 GEMM that K1 and K2 run inside (TMA + wgmma), alone, for
    tests and measurements: f32 ``(c +) A . B (+ bias)`` for bf16 operands
    stored as ``layout`` says ("fwd": a [M, K], b [K, N]; "dgrad": a [M, K],
    b [N, K]; "wgrad": a [K, M], b [K, N]) and ``bias`` f32 [N].  With
    ``c`` (f32 [M, N]) the result goes into ``c`` in place, as the skip
    layer's second GEMM adds into z; else into a new tensor.  ``split``
    splits K over CTAs through an f32 workspace and a fixed-order reduction,
    as K2's weight gradients do.

    CPU tensors: the plain version.  CUDA: the kernel on the current stream,
    or an error."""
    if a.device.type == "cpu":
        out = gemm_reference(a, b, layout, bias, c)
        return c.copy_(out) if c is not None else out
    if layout not in GEMM_LAYOUTS:
        raise ValueError(f"gemm_bf16: layout {layout!r} is not one of "
                         f"{sorted(GEMM_LAYOUTS)}")
    for t, what in ((a, "a"), (b, "b")):
        if t.device.type != "cuda" or t.device != a.device \
                or t.dtype != torch.bfloat16 or t.dim() != 2 \
                or not t.is_contiguous() or t.shape[1] % 8:
            raise ValueError(f"gemm_bf16: {what} must be a contiguous 2-D "
                             f"bf16 cuda tensor with rows of a multiple of 8 "
                             f"elements, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    A, B = gemm_operands(a, b, layout)
    (M, K), N = A.shape, B.shape[1]
    if B.shape[0] != K or min(M, N, K) < 1 or max(M, N, K) >= 2 ** 31:
        raise ValueError(f"gemm_bf16: {layout} operands {tuple(a.shape)} "
                         f"and {tuple(b.shape)} do not fit")
    for t, shape, what in ((bias, (N,), "bias"), (c, (M, N), "c")):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape
                              or t.device != a.device
                              or not t.is_contiguous()):
            raise ValueError(f"gemm_bf16: {what} must be contiguous f32 "
                             f"{shape} on {a.device}")
    out = c if c is not None else torch.empty((M, N), device=a.device)
    ws_floats = _MAX_SPLITS * M * N if split else 0
    ws = torch.empty((ws_floats,), device=a.device) if split else None
    a_kc, b_kc = GEMM_LAYOUTS[layout]
    FWD_LIB.launch("trunk_train_gemm_launch", a.device, a, int(a_kc),
                   a.shape[1], b, int(b_kc), b.shape[1], out, N, bias, M, N,
                   K, int(c is not None), int(split), ws, ws_floats,
                   context=f"gemm {layout} {M}x{N}x{K}")
    return out


class TrunkTrain(torch.autograd.Function):
    """Differentiable fused trunk: (spec, pe, *packed f32) -> (xenc, heads,
    stats).  The forward is K1, the backward K2.  Gradients flow to the
    packed params only (pe holds sample positions, not learned); stats is
    not differentiable.  The weights are cast to bf16 inside, so the f32
    gradients K2 returns reach the f32 packed weights unrounded, as the
    JAX ``custom_vjp`` returns them."""

    @staticmethod
    def forward(ctx, spec, pe, *packed):
        params = kernel_params(spec, packed)
        xenc, heads, stats = trunk_fwd(spec, pe, params)
        ctx.spec = spec
        ctx.save_for_backward(pe, *params)
        ctx.mark_non_differentiable(stats)
        return xenc, heads, stats

    @staticmethod
    def backward(ctx, d_xenc, d_heads, _d_stats):
        pe, *params = ctx.saved_tensors
        spec = ctx.spec
        n = pe.shape[0]
        if d_xenc is None:
            d_xenc = pe.new_zeros((n, spec.enc_width), dtype=torch.float32)
        if d_heads is None:
            d_heads = pe.new_zeros((n, HEAD_PAD), dtype=torch.float32)
        grads = trunk_bwd(spec, pe, params, d_xenc, d_heads)
        return (None, None, *grads)


# --- the training forwards ------------------------------------------------
def trunk_norms(gnerf):
    """The BatchNorm of each trunk layer that has one, in layer order."""
    return [layer.norm for layer, _ in trunk_layers(gnerf)
            if layer.norm is not None]


@torch.no_grad()
def batch_stats_updates(gnerf, spec: TrunkSpec, stats_sums: torch.Tensor,
                        n_tiles: int):
    """Update the trunk's running statistics in place from K1's sums, as
    flax's BatchNorm does (momentum 0.99): the batch statistics are the
    mean over tiles of the tile means and (biased) variances."""
    for k, norm in enumerate(trunk_norms(gnerf)):
        w = norm.running_mean.shape[0]
        mu = stats_sums[k, :w] / n_tiles
        var = stats_sums[spec.n_bn + k, :w] / n_tiles
        norm.running_mean.copy_(0.99 * norm.running_mean + 0.01 * mu)
        norm.running_var.copy_(0.99 * norm.running_var + 0.01 * var)


def spec_for_model(model, n_points: int, tile: int = 2048):
    """-> (TrunkSpec, None) for a ``TNeRF`` the fused path represents, or
    (None, reason): the reference family only (depth 8, 10-frequency
    extended PE, BatchNorm trunk, bf16, widths multiples of 128) and a
    point count that divides into tiles."""
    g = model.G_NeRF_net
    lw = g.fc1.linear.out_features
    if g.n_layers != 8:
        return None, "pallas_trunk requires the reference trunk depth (8)"
    if g.pe_pose != 10 or not g.extended:
        return None, "pallas_trunk requires the 10-freq extended pose PE"
    if g.fc2.norm is None:
        return None, "pallas_trunk requires the BatchNorm trunk (use_norm)"
    if model.dtype != torch.bfloat16:
        return None, "pallas_trunk requires compute_dtype=bfloat16"
    if lw % 128 != 0 or (lw // 2) % 128 != 0:
        return None, f"pallas_trunk requires 128-multiple widths (got {lw})"
    if n_points % tile != 0:
        return None, (f"batch points {n_points} not divisible by the ghost "
                      f"tile {tile} (batch_size * n_samples must be a "
                      f"multiple of {tile})")
    return TrunkSpec(widths=(lw,) * g.n_layers + (lw // 2,),
                     skip_idx=g.n_layers // 2, tile=tile,
                     fast_sine=g.fast_sine), None


def fused_forward(model, spec: TrunkSpec, flat, probs_f, sun_pe_f,
                  sky_raw_f):
    """``TNeRF.forward`` in training mode with the trunk and heads in K1/K2
    (ghost BN); the solar and adjust branches are plain PyTorch reading
    K1's x_enc.  Updates the trunk's running statistics.  -> the output
    dict of ``TNeRF.forward``."""
    g = model.G_NeRF_net
    pe = encode_pe(flat)
    xenc, heads, stats = TrunkTrain.apply(spec, pe, *pack_params(g, spec))
    vis_raw, sky_raw = g.solar(xenc, None, sun_pe=sun_pe_f,
                               sky_raw=sky_raw_f)
    adjust = torch.sum(model.adjust_from_enc(xenc) * probs_f[:, :, None],
                       dim=1)
    batch_stats_updates(g, spec, stats, flat.shape[0] // spec.tile)
    return {
        "rho": F.softplus(heads[:, 0:1]),
        "col": torch.sigmoid(heads[:, 1:4] + adjust),
        "vis": torch.sigmoid(vis_raw),
        "sky": torch.sigmoid(sky_raw),
        "class_probs": probs_f,
        "adjust": adjust,
    }


def fused_forward_solar(model, spec: TrunkSpec, flat, sun_pe_f, sky_raw_f):
    """``TNeRF.forward_solar`` with the trunk in K1 alone: the solar pass
    blocks gradients into the trunk, so no backward kernel runs; only the
    solar branch, which reads x_enc, carries gradients.  -> the output dict
    of ``TNeRF.forward_solar``."""
    g = model.G_NeRF_net
    with torch.no_grad():
        packed = kernel_params(spec, pack_params(g, spec))
        xenc, heads, stats = trunk_fwd(spec, encode_pe(flat), packed)
    vis_raw, sky_raw = g.solar(xenc, None, sun_pe=sun_pe_f,
                               sky_raw=sky_raw_f)
    batch_stats_updates(g, spec, stats, flat.shape[0] // spec.tile)
    return {"rho": F.softplus(heads[:, 0:1]),
            "vis": torch.sigmoid(vis_raw), "sky_raw": sky_raw}
