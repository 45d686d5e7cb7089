"""Core: configuration, stencil definitions, decomposition math and the
NumPy golden model. Pure Python/NumPy copies of ``heat3d_tpu.core``."""
