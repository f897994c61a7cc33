"""Season-NeRF in PyTorch for NVIDIA Hopper GPUs.

The serving path of the JAX package ``season_nerf_tpu`` (load a model
directory, render novel views and height maps, answer them over HTTP),
rewritten in PyTorch.  The inference trunk runs through a hand-written CUDA
kernel (``ops/fused_trunk.py`` + ``csrc/trunk_infer.cu``); everything else
is plain PyTorch.  Model directories are interchangeable with the JAX
package in both directions.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
