"""Device compute: the plain PyTorch stencil contract (``stencil_eager``)
and the CUDA kernels with their wrappers (``stencil_direct``: the BC-fused
direct kernels; ``stencil_stream``: the exchange-path stream and streamk
kernels; ``halo_dma``: the DMA halo exchange; built by ``_build``)."""


def _modules():
    from heat3d_tpu_torch.ops import halo_dma, stencil_direct, stencil_stream

    return stencil_direct, stencil_stream, halo_dma


def launch_counts() -> dict:
    """Launches of every kernel wrapper of the kernel modules."""
    counts = {}
    for m in _modules():
        counts.update(m.launch_counts())
    return counts


def reset_launch_counts() -> None:
    for m in _modules():
        m.reset_launch_counts()
