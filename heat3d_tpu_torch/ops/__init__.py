"""Device compute: the plain PyTorch stencil contract (``stencil_eager``)
and the CUDA kernels with their wrappers (``stencil_direct``: the BC-fused
direct kernels; ``stencil_stream``: the exchange-path stream and streamk
kernels; ``halo_dma``: the DMA halo exchange; ``stencil_dma_fused`` and
``stencil_fused_rdma``: the fused exchange-and-sweep kernels; built by
``_build``)."""


def _modules():
    from heat3d_tpu_torch.ops import (
        halo_dma,
        stencil_direct,
        stencil_dma_fused,
        stencil_fused_rdma,
        stencil_stream,
    )

    return stencil_direct, stencil_stream, halo_dma, stencil_dma_fused, stencil_fused_rdma


def launch_counts() -> dict:
    """Launches of every kernel wrapper of the kernel modules."""
    counts = {}
    for m in _modules():
        counts.update(m.launch_counts())
    return counts


def cell_counts() -> dict:
    """Output cells of every kernel wrapper's launches (the DMA pairs: the
    ghost cells they wrote)."""
    counts = {}
    for m in _modules():
        counts.update(m.cell_counts())
    return counts


def compute_bf16_launch_counts() -> dict:
    """Launches in bf16 compute of every stencil kernel wrapper (the DMA
    halo pair moves bytes and computes nothing)."""
    from heat3d_tpu_torch.ops import halo_dma

    counts = {}
    for m in _modules():
        if m is not halo_dma:
            counts.update(m.compute_bf16_launch_counts())
    return counts


def reset_launch_counts() -> None:
    for m in _modules():
        m.reset_launch_counts()
