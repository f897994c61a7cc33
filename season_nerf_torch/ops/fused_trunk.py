"""The fused inference trunk (K3): fold, plain version, and CUDA kernel.

The counterpart of ``season_nerf_tpu/ops/pallas_mlp.py``.  At inference
the trunk's BatchNorms are affine in the running statistics, so each SIREN
layer folds to ``sin(x @ W'^T + b')`` with

    s  = gamma / sqrt(var + eps)
    W' = omega * W * s[:, None]           ([out, in], the torch layout)
    b' = (omega * b - mean) * s + beta

(fc1 has no norm).  :func:`fold_trunk` does this once per loaded model, in
float64 on the host, then casts and keeps the result on the device.  It
works from a layer table, so it serves every depth and width the model
builds: widths are zero-padded to a multiple of 128 (one slot of the bf16
kernel's weight ring, two of its 64-wide K chunks) and the 63-wide
positional encoding to 64; padded outputs are sin(0) = 0 and padded inputs
meet zero weights.

:func:`trunk_apply` is the kernel's wrapper.  It calls the operator
``season_nerf::trunk_apply`` (:func:`trunk_op`, a ``torch.library``
custom op, so that ``torch.export`` records the call and an exported
render program reaches the same kernel): for a CPU tensor the plain
version, :func:`trunk_apply_reference`; for a CUDA tensor a launch of
``csrc/trunk_infer.cu`` or an error, counted as ``k3.launches``
(``utils/trace``; each launch is the span ``k3.launch``).  The bf16
kernel (TMA + wgmma, clusters of two 64-row tiles) reads each layer's W'
through a tensor map:
:meth:`FoldedTrunk.launch_plan`
says per layer what the map covers, and :meth:`FoldedTrunk.tensor_maps`
encodes the maps once per folded trunk (above a padded width of 512 the
cluster's two CTAs share a tile and split its columns).  The f32 kernel
(FFMA, a producer warp and a ring of weight slots) streams the f32 copy of
every W' that :func:`fold_trunk` lays out as W'^T, the layers one after
the other (:attr:`FoldedTrunk.ring_weights`), as
:meth:`FoldedTrunk.f32_plan` says (64-row tiles up to a padded width of
512, 32-row tiles above).  Both take padded widths up to ``MAX_WIDTH`` and up
to ``MAX_LAYERS`` layers.  :func:`k3_refusal` says, from a
model's config alone, whether K3 takes it; the entry points ask it before
they build anything on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import weakref
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from season_nerf_torch.models.encodings import encoded_size, positional_encode
from season_nerf_torch.models.siren import BN_EPS
from season_nerf_torch.ops.cuda_build import Library
from season_nerf_torch.ops.fast_math import plain_sin
from season_nerf_torch.utils import trace

PE_FREQS = 10
PE_DIM = encoded_size(3, PE_FREQS)      # 63
MULTIPLE = 128                          # padding of every width
KERNEL = "trunk_infer"
CLUSTER = 2             # CTAs of the bf16 kernel's cluster (trunk_infer.cu)
SLOT_ROWS = 128         # W' rows of a slot of its weight ring
MAX_WIDTH = 1024        # the kernels' widest padded layer
MAX_LAYERS = 17         # the kernels' deepest trunk: fc1..fc16 + fc9
_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = Library(KERNEL, {
    "trunk_bf16_encode": (_P, _I, _I, _P),
    "trunk_bf16_launch": (_P, _I, _P, _P, _P, _I, _I, _I, _P),
    "trunk_f32_launch": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _P)})


def _pad_to(n: int) -> int:
    return -(-n // MULTIPLE) * MULTIPLE


PE_PAD = 64                             # one 64-wide K chunk


@dataclasses.dataclass
class FoldedTrunk:
    """Folded, padded trunk weights and what the kernels read of them.

    ``weights[i]`` is ``[n_pad, k_pad]`` in the compute dtype and
    ``biases[i]`` ``[n_pad]`` float32.  ``inputs[i]`` names what layer i
    reads: ``"pe"`` (fc1), ``"h"``, or ``"h+pe"`` (the skip layer, laid
    out as ``[h (width_pad) | PE (PE_PAD)]``).  ``ring_weights`` (float32
    folds only) is the f32 kernel's copy: every ``weights[i].t()``
    (``[k_pad, n_pad]``) flattened, the layers one after the other."""
    weights: List[torch.Tensor]
    biases: List[torch.Tensor]
    inputs: List[str]
    width_pad: int
    out_features: int
    width: Optional[int] = None         # unpadded; None: width_pad
    ring_weights: Optional[torch.Tensor] = None
    _plan: Optional[torch.Tensor] = None
    _f32_plan: Optional[torch.Tensor] = None
    _maps: Optional[torch.Tensor] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.weights[0].dtype

    def f32_plan(self) -> torch.Tensor:
        """The f32 kernel's plan, int64 on the host, one row per layer
        (``F32Field`` in ``trunk_infer.cu``): b''s pointer, k, n, the row of
        the tile's activations where the layer's input starts (the PE's rows
        follow h's ``width_pad`` rows: fc1 starts there, every later layer
        at 0), the offset of its W'^T in :attr:`ring_weights`, and the k of
        its input where the PE starts (fc1: 0; the skip layer: after h's
        ``width_pad``; -1 where none).  Built once."""
        if self._f32_plan is None:
            rows, off = [], 0
            for w, b, kind in zip(self.weights, self.biases, self.inputs):
                n, k = w.shape
                rows.append([b.data_ptr(), k, n,
                             self.width_pad if kind == "pe" else 0, off,
                             {"pe": 0, "h": -1,
                              "h+pe": self.width_pad}[kind]])
                off += k * n
            self._f32_plan = torch.tensor(rows, dtype=torch.int64)
        return self._f32_plan

    def launch_plan(self) -> torch.Tensor:
        """The bf16 kernel's plan, int64 on the host, one row per layer
        (``PlanField`` in ``trunk_infer.cu``): W' and b' pointers, k, n,
        the tensor map's box (64 K x SLOT_ROWS / CLUSTER W' rows: each CTA
        of the cluster loads its share of a slot of the kernel's weight
        ring and multicasts it), W''s row stride in bytes, and the K chunk
        that reads the PE (fc1: 0; the skip layer: after h's chunks; -1
        where none does).  Built once."""
        if self._plan is None:
            rows = []
            for w, b, kind in zip(self.weights, self.biases, self.inputs):
                n, k = w.shape
                pe_chunk = {"pe": 0, "h": -1,
                            "h+pe": self.width_pad // 64}[kind]
                rows.append([w.data_ptr(), b.data_ptr(), k, n, 64,
                             SLOT_ROWS // CLUSTER, k * w.element_size(),
                             pe_chunk])
            self._plan = torch.tensor(rows, dtype=torch.int64)
        return self._plan

    def tensor_maps(self) -> torch.Tensor:
        """The bf16 kernel's tensor maps of every W', 128 bytes a layer on
        the host, encoded once (the weights do not change)."""
        if self._maps is None:
            plan = self.launch_plan()
            maps = torch.zeros(len(self.weights) * 128, dtype=torch.uint8)
            err = LIB.call("trunk_bf16_encode", plan, len(self.weights),
                           self.out_features, maps)
            if err != 0:
                raise ValueError(f"the bf16 trunk kernel cannot map these "
                                 f"weights (error {err}): widths "
                                 f"{[tuple(w.shape) for w in self.weights]}")
            self._maps = maps
        return self._maps


def trunk_layers(gnerf):
    """The trunk of a ``GNeRF`` as [(SineLayer, input kind)]."""
    layers = [(getattr(gnerf, f"fc{i}"),
               "pe" if i == 1 else "h+pe" if i == gnerf.skip else "h")
              for i in range(1, gnerf.n_layers + 1)]
    return layers + [(gnerf.fc9, "h")]


def fold_trunk(gnerf, dtype: torch.dtype = torch.float32,
               device=None) -> FoldedTrunk:
    """Fold omega and the BN running statistics of ``gnerf``'s trunk into
    padded ``(W', b')`` per layer (float64 math, then ``dtype``)."""
    return fold_layers(trunk_layers(gnerf), dtype, device)


def fold_layers(layers, dtype: torch.dtype = torch.float32,
                device=None) -> FoldedTrunk:
    """:func:`fold_trunk` of a trunk given as [(SineLayer, input kind)]
    (:func:`trunk_layers`): fc1 reads the PE, the last layer's width is
    the output's."""
    first = layers[0][0].linear.weight
    device = device if device is not None else first.device
    width = first.shape[0]
    wp = _pad_to(width)
    weights, biases, inputs = [], [], []
    for layer, kind in layers:
        f64 = lambda t: t.detach().to("cpu", torch.float64).numpy()
        W = layer.omega_0 * f64(layer.linear.weight)          # [out, in]
        b = layer.omega_0 * f64(layer.linear.bias)
        if layer.norm is not None:
            n = layer.norm
            s = f64(n.weight) / np.sqrt(f64(n.running_var) + BN_EPS)
            W = W * s[:, None]
            b = (b - f64(n.running_mean)) * s + f64(n.bias)
        out = W.shape[0]
        Wp = np.zeros((_pad_to(out), {"pe": PE_PAD, "h": wp,
                                      "h+pe": wp + PE_PAD}[kind]))
        if kind == "pe":
            Wp[:out, :PE_DIM] = W
        elif kind == "h":
            Wp[:out, :width] = W
        else:
            Wp[:out, :width] = W[:, :width]
            Wp[:out, wp:wp + PE_DIM] = W[:, width:]
        bp = np.zeros(_pad_to(out))
        bp[:out] = b
        weights.append(torch.from_numpy(Wp).to(device=device, dtype=dtype)
                       .contiguous())
        biases.append(torch.from_numpy(bp).to(device=device,
                                              dtype=torch.float32))
        inputs.append(kind)
    ring = (torch.cat([w.t().reshape(-1) for w in weights])
            if dtype == torch.float32 else None)
    return FoldedTrunk(weights, biases, inputs, wp,
                       layers[-1][0].linear.out_features, width, ring)


def encode_points(x: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, 64] zero-padded extended PE, float32."""
    pe = positional_encode(x.float(), PE_FREQS, True)
    return torch.nn.functional.pad(pe, (0, PE_PAD - PE_DIM))


def trunk_apply_reference(pe: torch.Tensor, folded: FoldedTrunk,
                          fast_sine: bool = False,
                          acc_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The plain version of K3: [N, 64] f32 PE -> [N, out_features] f32.
    Each layer's input is cast to W's dtype, the product accumulates in
    float32 (bf16 x bf16 products are exact in f32), b' is added in f32.
    The padding's rows and columns of W' are zero, so only the unpadded
    ones are computed.  ``acc_dtype=torch.float64`` accumulates each
    layer's sum in float64 and rounds it once to float32: the same function
    in another summation order, which says how far the order alone moves a
    trunk's output."""
    sin = plain_sin if fast_sine else torch.sin
    width, wp = folded.width or folded.width_pad, folded.width_pad
    h = None
    last = len(folded.weights) - 1
    for i, (w, b, kind) in enumerate(zip(folded.weights, folded.biases,
                                         folded.inputs)):
        n = folded.out_features if i == last else width
        if kind == "pe":
            x, w = pe, w[:n]
        elif kind == "h":
            x, w = h, w[:n, :width]
        else:
            x = torch.cat([h, pe], 1)
            w = torch.cat([w[:n, :width], w[:n, wp:]], 1)
        h = sin((x.to(w.dtype).to(acc_dtype) @ w.to(acc_dtype).t()
                 + b[:n]).float())
    return h


def _limit_refusal(bf16: bool, width_pad: int, layers: int,
                   what: str) -> Optional[str]:
    kernel = "bf16" if bf16 else "f32"
    if width_pad > MAX_WIDTH:
        return (f"the {kernel} trunk kernel (K3) takes padded widths up to "
                f"{MAX_WIDTH} (fc_units <= {MAX_WIDTH}), got {width_pad}"
                f"{what}")
    if layers > MAX_LAYERS:
        return (f"the {kernel} trunk kernel (K3) takes up to {MAX_LAYERS} "
                f"layers (fc_layers <= {MAX_LAYERS - 1}), got {layers}"
                f"{what}")
    return None


def k3_refusal(fc_units: int, fc_layers: int,
               compute_dtype: Optional[str]) -> Optional[str]:
    """Why K3 cannot run the trunk of a model of this shape, naming the
    limit, or None.  ``compute_dtype`` as a Config holds it: "bfloat16"
    takes the bf16 kernel, anything else (a legacy directory's None too)
    the f32 one.  The plain version on the CPU takes every shape."""
    return _limit_refusal(compute_dtype == "bfloat16", _pad_to(fc_units),
                          fc_layers + 1,
                          f" (fc_units {fc_units}, fc_layers {fc_layers})")


def refuse_on_card(cfg, device):
    """Raise ValueError where ``device`` is a card and K3 cannot take the
    model ``cfg`` describes (:func:`k3_refusal`): the entry points call it
    before they build a model, a table or a fold."""
    if torch.device(device).type != "cuda":
        return
    why = k3_refusal(cfg.fc_units, cfg.fc_layers,
                     getattr(cfg, "compute_dtype", None))
    if why is not None:
        raise ValueError(why)


def _check_f32_layout(folded: FoldedTrunk, device):
    """Raise unless the f32 kernel can stream ``folded``: its ring copy
    on ``device``, holding every W' as W'^T."""
    ring = folded.ring_weights
    if ring is None or ring.dtype != torch.float32 \
            or ring.device != device or not ring.is_contiguous() \
            or ring.numel() != sum(w.numel() for w in folded.weights):
        raise ValueError("the f32 trunk kernel needs the fold's ring copy "
                         "of its weights (FoldedTrunk.ring_weights, built "
                         "by fold_trunk) on the PE's device")


def _kinds(skip: int, n_layers: int) -> List[str]:
    """The input kinds of an ``n_layers`` trunk whose layer ``skip`` (-1:
    none) reads the PE again: fc1 the PE, every other layer h."""
    return ["pe" if i == 0 else "h+pe" if i == skip else "h"
            for i in range(n_layers)]


def _folded_of(weights, biases, ring, skip, width, width_pad,
               out_features) -> FoldedTrunk:
    return FoldedTrunk(list(weights), list(biases),
                       _kinds(skip, len(weights)), width_pad, out_features,
                       width, ring)


# The operator K3 is reached through on every path: the renderer's
# FusedTrunk and an exported program (tools/export_render.py) call the
# same function.  Its arguments are tensors and scalars only, so that
# torch.export can record a call: the padded PE, the folded W' and b' of
# every layer, the f32 kernel's ring copy (None for bf16), the skip layer's
# index (-1: none), the unpadded and padded widths, the output width and
# the sine.  The CPU implementation is the plain version; the CUDA one
# launches K3 or raises; the fake one gives the output's shape alone.
@torch.library.custom_op("season_nerf::trunk_apply", mutates_args=())
def trunk_op(pe: torch.Tensor, weights: List[torch.Tensor],
             biases: List[torch.Tensor], ring: Optional[torch.Tensor],
             skip: int, width: int, width_pad: int, out_features: int,
             fast_sine: bool) -> torch.Tensor:
    return trunk_apply_reference(
        pe, _folded_of(weights, biases, ring, skip, width, width_pad,
                       out_features), fast_sine)


@trunk_op.register_fake
def _trunk_op_fake(pe, weights, biases, ring, skip, width, width_pad,
                   out_features, fast_sine):
    return pe.new_empty((pe.shape[0], out_features), dtype=torch.float32)


# launch state by the weights' addresses and shapes -> (weak references to
# those tensors, the kernel's plan and tensor maps or f32 plan): built once
# per set of weights, whether they come from a FusedTrunk or an exported
# program's constants, and dropped once the weights are gone (an address
# freed and reused by other weights misses: the references differ)
_launch_states: dict = {}


def _launch_state(weights, biases, ring, skip, width_pad, out_features,
                  bf16: bool):
    tensors = [*weights, *biases] + ([ring] if ring is not None else [])
    key = (bf16, skip, width_pad, out_features,
           tuple((t.data_ptr(), tuple(t.shape)) for t in tensors))
    with _lock:
        hit = _launch_states.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[1]
    folded = _folded_of(weights, biases, ring, skip, None, width_pad,
                        out_features)
    state = ((folded.launch_plan(), folded.tensor_maps()) if bf16
             else (folded.f32_plan(),))
    with _lock:
        for k in [k for k, (refs, _) in _launch_states.items()
                  if any(r() is None for r in refs)]:
            del _launch_states[k]
        _launch_states[key] = ([weakref.ref(t) for t in tensors], state)
    return state


@trunk_op.register_kernel("cuda")
def _trunk_op_cuda(pe, weights, biases, ring, skip, width, width_pad,
                   out_features, fast_sine):
    if pe.dtype != torch.float32 or pe.dim() != 2 \
            or pe.shape[1] != PE_PAD or not pe.is_contiguous():
        raise ValueError(f"trunk_apply takes a contiguous [N, {PE_PAD}] "
                         f"float32 PE, got {tuple(pe.shape)} {pe.dtype}")
    dtype = weights[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"trunk kernel takes float32 or bfloat16 weights, "
                         f"got {dtype}")
    for t in list(weights) + list(biases):
        if t.device != pe.device or not t.is_contiguous():
            raise ValueError("folded trunk weights must be contiguous and on "
                             f"the PE's device {pe.device}")
    bf16 = dtype == torch.bfloat16
    why = _limit_refusal(bf16, width_pad, len(weights), "")
    if why is not None:
        raise ValueError(why)
    if not bf16:
        _check_f32_layout(_folded_of(weights, biases, ring, skip, width,
                                     width_pad, out_features), pe.device)
    n = pe.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"trunk kernel takes fewer than 2^31 rows, got {n}")
    out = torch.empty((n, out_features), dtype=torch.float32,
                      device=pe.device)
    if n == 0:
        return out
    state = _launch_state(weights, biases, ring, skip, width_pad,
                          out_features, bf16)
    widths = f"widths {width_pad} + PE {PE_PAD}"
    with trace.span("k3.launch"):
        if bf16:
            plan, maps = state
            LIB.launch("trunk_bf16_launch", pe.device, plan, len(weights),
                       maps, pe, out, n, out_features, int(fast_sine),
                       counter="k3.launches", context=widths)
        else:
            LIB.launch("trunk_f32_launch", pe.device, state[0],
                       len(weights), ring, pe, out, n, out_features,
                       width_pad, int(fast_sine), counter="k3.launches",
                       context=widths)
    return out


def trunk_apply(pe: torch.Tensor, folded: FoldedTrunk,
                fast_sine: bool = False) -> torch.Tensor:
    """[N, 64] float32 PE -> [N, out_features] float32 x_enc, through the
    operator ``season_nerf::trunk_apply`` (:func:`trunk_op`).

    CPU tensor: the plain version.  CUDA tensor: the hand-written kernel
    (``csrc/trunk_infer.cu``), launched on the current stream, or an error.
    """
    if pe.device.type not in ("cpu", "cuda"):
        raise ValueError(f"trunk_apply takes a cpu or cuda tensor, got "
                         f"{pe.device}")
    n = len(folded.inputs)
    skip = folded.inputs.index("h+pe") if "h+pe" in folded.inputs else -1
    if folded.inputs != _kinds(skip, n):
        raise ValueError(f"trunk_apply takes fc1 on the PE and at most one "
                         f"skip layer, got inputs {folded.inputs}")
    return trunk_op(pe, folded.weights, folded.biases, folded.ring_weights,
                    skip, folded.width or folded.width_pad,
                    folded.width_pad, folded.out_features, fast_sine)


_lock = threading.Lock()                    # guards _launch_states


class FusedTrunk:
    """A ``GNeRF``'s trunk folded once onto its device, evaluated through
    :func:`trunk_apply`.  The network's own heads stay plain PyTorch
    (``models/tnerf``); :meth:`sigma` and :meth:`sigma_color` apply the
    sigma and color heads in float32, as the JAX ``FusedTrunk`` does."""

    def __init__(self, gnerf):
        self.gnerf = gnerf
        self.fast_sine = gnerf.fast_sine
        self.folded = fold_trunk(gnerf, gnerf.dtype or torch.float32)

    def x_enc(self, pts: torch.Tensor) -> torch.Tensor:
        """[N, 3] points -> [N, width/2] float32 encoding."""
        return trunk_apply(encode_points(pts).contiguous(), self.folded,
                           self.fast_sine)

    def _head(self, head, enc):
        return F.linear(enc, head.weight.float(), head.bias.float())

    @torch.no_grad()
    def sigma(self, pts: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> softplus(rho_raw) [N, 1]: density alone."""
        return F.softplus(self._head(self.gnerf.fc10Sigma, self.x_enc(pts)))

    @torch.no_grad()
    def sigma_color(self, pts: torch.Tensor):
        """[N, 3] -> (softplus(rho_raw) [N, 1], col_raw [N, 3])."""
        enc = self.x_enc(pts)
        return (F.softplus(self._head(self.gnerf.fc10Sigma, enc)),
                self._head(self.gnerf.fc10Col, enc))
