"""Season-NeRF in PyTorch for NVIDIA Hopper GPUs.

The serving path of the JAX package ``season_nerf_tpu`` (load a model
directory, render novel views and height maps, answer them over HTTP),
rewritten in PyTorch.  The inference trunk runs through a hand-written CUDA
kernel (``ops/fused_trunk.py`` + ``csrc/trunk_infer.cu``); everything else
is plain PyTorch.  Model directories are interchangeable with the JAX
package in both directions.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

# registers the operator ``season_nerf::trunk_apply`` (K3), which a render
# program saved by ``tools/export_render.py`` calls: loading one needs this
# package imported
from season_nerf_torch.ops import fused_trunk as _fused_trunk  # noqa: E402,F401
