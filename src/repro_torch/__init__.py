"""PyTorch/CUDA port of the packet-path FedAvg server (``repro``'s twin).

The package mirrors ``src/repro`` module for module and imports neither
JAX nor anything of the JAX package, so it runs on a machine that has
only PyTorch.  Its entry points run on the CUDA device unless the
caller passes ``device="cpu"``; on CPU tensors every hand-written kernel
is replaced by its plain PyTorch version.
"""
