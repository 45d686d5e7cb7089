"""Device compute: the plain PyTorch stencil contract (``stencil_eager``)
and the CUDA stencil kernels with their wrappers (``stencil_direct``: the
BC-fused direct kernels; ``stencil_stream``: the exchange-path stream and
streamk kernels; built by ``_build``)."""


def launch_counts() -> dict:
    """Launches of every kernel wrapper of both kernel modules."""
    from heat3d_tpu_torch.ops import stencil_direct, stencil_stream

    return {**stencil_direct.launch_counts(), **stencil_stream.launch_counts()}


def reset_launch_counts() -> None:
    from heat3d_tpu_torch.ops import stencil_direct, stencil_stream

    stencil_direct.reset_launch_counts()
    stencil_stream.reset_launch_counts()
