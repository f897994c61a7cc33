"""Export a trained model's render chunk function as a ``torch.export``
program.

The serving-side render function (``Renderer._full_chunk``'s contract:
per-ray rendered colour, raw shadow visibility, expected surface height,
accumulated opacity) with the trained weights and the folded trunk baked
in as constants, saved with ``torch.export.save`` into one file.  Another
process loads it with ``torch.export.load`` and calls it on ``[chunk, 3]``
ray tensors; the program calls the inference trunk K3 through the operator
``season_nerf::trunk_apply``, so loading needs ``import
season_nerf_torch``, which registers it (the JAX tool's artifact needs
jax alone):

    python -m season_nerf_torch.tools.export_render <model_dir> \\
        [-o render.pt2] [--chunk N] [--check] \\
        [--fast_render N_COARSE N_FINE] [--device cpu]

The counterpart of ``tools/export_render.py``, with its functions, flags
and manifest (``render.pt2.json``, with the device the program was
exported for and how to load it).  The program is a fixed-``chunk``,
single-device program: chunking stays with the caller, as in the live
Renderer's loop.  It runs on the card it was exported on (``--device``,
default ``cuda``), or on the CPU through the plain version of K3.
"""

from __future__ import annotations

import argparse
import io
import json
import os

import numpy as np
import torch

from season_nerf_torch.render.renderer import (render_chunk_outputs,
                                               render_chunk_outputs_fast)

CALL = ("f(tops[chunk,3], bots[chunk,3], sun[chunk,3], t4[chunk,4])"
        " -> {rendered[chunk,3], shadow_raw[chunk], height[chunk],"
        " ps_sum[chunk]}")


class RenderChunk(torch.nn.Module):
    """The per-chunk render function of ``model`` (a ``TNeRF`` in eval
    mode): the live renderer's own ``render_chunk_outputs``, or
    ``render_chunk_outputs_fast`` with ``fast_render=(n_coarse,
    n_fine)``, so the exported program cannot drift from
    ``Renderer._full_chunk``."""

    def __init__(self, model, n_samples: int, classic_solar: bool,
                 fast_render=None):
        super().__init__()
        self.model = model
        self.n_samples = n_samples
        self.classic_solar = classic_solar
        self.fast_render = tuple(fast_render) if fast_render else None

    def forward(self, tops, bots, sun, t4):
        if self.fast_render is not None:
            return render_chunk_outputs_fast(
                self.model, tops, bots, sun, t4,
                n_coarse=self.fast_render[0], n_fine=self.fast_render[1],
                classic_solar=self.classic_solar)
        return render_chunk_outputs(self.model, tops, bots, sun, t4,
                                    n_samples=self.n_samples,
                                    classic_solar=self.classic_solar)


def build_render_fn(model, n_samples: int, classic_solar: bool,
                    fast_render=None) -> RenderChunk:
    """The live per-chunk render function (the JAX tool's takes the
    variables too; here the weights are the model's)."""
    return RenderChunk(model.eval(), n_samples, classic_solar, fast_render)


def export_render(model, n_samples: int, chunk: int,
                  classic_solar: bool = False, use_hsluv: bool = False,
                  fast_render=None):
    """Export the render chunk function of ``model`` at ``chunk`` rays on
    the model's device -> (the saved program: bytes, manifest: dict).

    The trunk is folded before tracing, so the folded weights are the
    program's constants and the fold's arithmetic stays out of the graph;
    the weights are exported without gradients (an inference program)."""
    device = next(model.parameters()).device
    fn = build_render_fn(model, n_samples, classic_solar, fast_render)
    args = tuple(torch.zeros((chunk, k), dtype=torch.float32, device=device)
                 for k in (3, 3, 3, 4))
    grads = [(p, p.requires_grad) for p in model.parameters()]
    buf = io.BytesIO()
    try:
        for p, _ in grads:
            p.requires_grad_(False)
        model.G_NeRF_net.fused()        # after eval(), which drops a fold
        torch.export.save(torch.export.export(fn, args), buf)
    finally:
        for p, flag in grads:
            p.requires_grad_(flag)
    manifest = {
        "format": "torch.export ExportedProgram",
        "call": CALL,
        "chunk": chunk,
        "n_samples": n_samples,
        "fast_render": list(fast_render) if fast_render else None,
        "classic_solar": classic_solar,
        "dtype": "float32",
        # a use_HSLuv-trained model's colour head emits normalized HSLuv
        # (h/360, s/100, l/100); the live Renderer converts to sRGB on the
        # host (utils/hsluv.hsluv_normalized_to_rgb), and so must a
        # consumer of this program
        "color_space": "hsluv-normalized" if use_hsluv else "srgb",
        "note": "single-device program; drive chunking/sharding host-side",
        "device": str(device),
        "load": "import season_nerf_torch (it registers the operator "
                "season_nerf::trunk_apply), then "
                "torch.export.load(path).module(); call it on float32 "
                "tensors on the device above",
    }
    return buf.getvalue(), manifest


def load_exported(path: str):
    """A saved program -> the callable ``f(tops, bots, sun, t4)``.  Needs
    ``season_nerf_torch`` imported, as importing this module does."""
    return torch.export.load(path).module()


def check_rays(chunk: int):
    """The JAX tool's ``--check`` rays: vertical rays over the cube's top
    face from seed 0, one sun and one time -> (tops, bots, sun, t4)."""
    rng = np.random.default_rng(0)
    tops = np.concatenate([rng.uniform(-1, 1, (chunk, 2)),
                           np.ones((chunk, 1))], 1).astype(np.float32)
    bots = np.concatenate([tops[:, :2], -np.ones((chunk, 1))],
                          1).astype(np.float32)
    sun = np.broadcast_to(np.array([0.3, 0.2, 0.93], np.float32),
                          (chunk, 3)).copy()
    t4 = np.broadcast_to(np.array([1, 0, 1, 0], np.float32),
                         (chunk, 4)).copy()
    return tops, bots, sun, t4


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model_dir")
    p.add_argument("-o", "--output", default=None,
                   help="program path (default <model_dir>/render.pt2)")
    p.add_argument("--chunk", type=int, default=None,
                   help="rays per call (default: the run's --chunk)")
    p.add_argument("--check", action="store_true",
                   help="load the saved program back and compare it with "
                        "the live renderer on the check rays")
    p.add_argument("--fast_render", type=int, nargs=2, default=None,
                   metavar=("N_COARSE", "N_FINE"),
                   help="export the depth-guided fast render instead of "
                        "the exact uniform sampler")
    p.add_argument("--device", default="cuda",
                   help="torch device to export for (default cuda)")
    args = p.parse_args(argv)

    from season_nerf_torch.render.loading import load_model_dir

    loaded = load_model_dir(args.model_dir, device=args.device)
    cfg, model = loaded.cfg, loaded.model
    chunk = args.chunk or cfg.chunk
    blob, manifest = export_render(model, cfg.n_samples, chunk,
                                   classic_solar=cfg.Solar_Type_2,
                                   use_hsluv=cfg.use_HSLuv,
                                   fast_render=args.fast_render)
    if cfg.use_HSLuv:
        print("note: model trained in HSLuv — the program's 'rendered' "
              "output is normalized HSLuv (see manifest color_space); "
              "convert to sRGB host-side")
    out = args.output or os.path.join(args.model_dir, "render.pt2")
    with open(out, "wb") as f:
        f.write(blob)
    with open(out + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"wrote {out} ({len(blob) / 1e6:.1f} MB) + manifest")

    if args.check:
        program = load_exported(out)
        rays = [torch.from_numpy(a).to(args.device)
                for a in check_rays(chunk)]
        fn = build_render_fn(model, cfg.n_samples, cfg.Solar_Type_2,
                             args.fast_render)
        with torch.no_grad():
            got, want = program(*rays), fn(*rays)
        for k in want:
            np.testing.assert_allclose(got[k].cpu().numpy(),
                                       want[k].cpu().numpy(),
                                       rtol=2e-5, atol=2e-5, err_msg=k)
        print("round-trip check passed: exported == live renderer")
    return out


if __name__ == "__main__":
    main()
