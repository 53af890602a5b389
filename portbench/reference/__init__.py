"""The benchmark's plain reference of the published UnCLTMO generator and its
tone-mapping pipeline: plain PyTorch and NumPy, written from the published
description (reference repository github.com/cao-cong/UnCLTMO), importing
nothing of the program under test nor of the JAX package."""
