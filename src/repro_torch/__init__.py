"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The package mirrors ``repro``'s module names so each counterpart is easy to
find, but imports nothing of it: modules that hold no numerics are kept as
copies here. Entry points run on the GPU (``device="cuda"``) unless the
caller passes ``device="cpu"``.
"""
