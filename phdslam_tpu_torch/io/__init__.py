"""Dataset loaders and log writers compatible with the reference toolchain."""
