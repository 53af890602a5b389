"""The GAN training step of the port."""
