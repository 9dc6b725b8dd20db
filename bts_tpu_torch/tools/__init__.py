"""Scripts of the port (``python -m``): measurements on a CUDA card and the
ArrayRecord converter."""
