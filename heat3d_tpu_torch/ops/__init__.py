"""Device compute: the plain PyTorch stencil contract (``stencil_eager``)
and the CUDA direct-stencil kernels with their wrappers
(``stencil_direct``, built by ``_build``)."""
