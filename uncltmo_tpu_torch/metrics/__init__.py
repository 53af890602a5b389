"""Image-quality metrics of the port."""
