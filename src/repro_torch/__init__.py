"""PyTorch / CUDA port of the SwarmSGD system (the JAX package ``repro`` is
its reference). Imports torch, numpy and the standard library only."""
