"""PyTorch / CUDA port of the UnCLTMO tone-mapping system for NVIDIA Hopper.

A package of its own beside the JAX reference package (`uncltmo_tpu`): it
imports torch and numpy, never jax and nothing of `uncltmo_tpu`.  Tensors
are NCHW inside the models; the public image functions keep the JAX
package's (H, W, C) layout so the two compare like with like.

The two TPU kernels of the image path are hand-written for Hopper
(`ops/kernels/`): the skip-connection concat in Triton and the fused double
3x3 conv in CUDA C++.  On a CUDA tensor the model always launches them; on
a CPU tensor it runs their plain PyTorch versions.
"""
