"""HeatSolver3D — explicit 3D heat diffusion on one CUDA device.

Port of ``heat3d_tpu.models.heat3d.HeatSolver3D`` for the single-device
explicit-Euler solve: ``init_state`` -> ``run`` (fixed steps) or
``run_to_convergence``, plus ``step``, ``step_with_residual`` and
``gather``. Updates go through the routes of ``parallel.step``: the
direct-stencil kernels (``ops.stencil_direct``), or the exchange path with
the stream/streamk kernels (``ops.stencil_stream``) or the backend's
plain/conv arm. The solver runs on ``cuda`` unless the caller passes
``device="cpu"``, where the kernels' plain versions run (tests); on a host
without CUDA, asking for the default device raises.

Not ported yet: checkpoints, the supervised/elastic run, slice dumps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from heat3d_tpu_torch.core import golden
from heat3d_tpu_torch.core.config import SolverConfig
from heat3d_tpu_torch.ops.stencil_eager import (
    apply_taps_conv_padded,
    apply_taps_padded,
)
from heat3d_tpu_torch.ops.stencil_stream import make_stream_compute
from heat3d_tpu_torch.parallel.step import (
    LocalCompute,
    PadBuffers,
    PingPong,
    _solver_taps,
    make_converge_fn,
    make_multistep_fn,
    make_step_fn,
)


def resolved_backend_name(cfg: SolverConfig) -> str:
    """The concrete backend name of this config's padded-block compute:
    'auto' resolves to 'pallas', the port's kernels (on the card; their
    plain versions on the CPU). Only an explicit request picks 'jnp' or
    'conv'."""
    return "pallas" if cfg.backend == "auto" else cfg.backend


def _into(fn) -> LocalCompute:
    def compute(up, taps, out=None):
        res = fn(up, taps)
        return res if out is None else out.copy_(res)

    return compute


def _select_backend(cfg: SolverConfig) -> LocalCompute:
    """The padded-block compute ``(up, taps, out=None) -> interior`` of the
    exchange path (port of the JAX ``_select_backend``):

    'pallas' / 'auto' -- the stream kernel (``make_stream_compute``);
    'jnp'  -- the plain PyTorch tap chain (``apply_taps_padded``);
    'conv' -- one ``F.conv3d`` (``apply_taps_conv_padded``), the library
              A/B arm."""
    name = resolved_backend_name(cfg)
    if name == "jnp":
        return _into(apply_taps_padded)
    if name == "conv":
        return _into(apply_taps_conv_padded)
    return make_stream_compute(cfg)


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means the current CUDA device, and raises without CUDA: the
    port never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: heat3d_tpu_torch runs on the GPU; pass "
                "device='cpu' explicitly to run the kernels' plain versions"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclasses.dataclass
class RunResult:
    u: torch.Tensor
    steps: int
    residual: Optional[float] = None


class HeatSolver3D:
    """The step functions of one SolverConfig on one device.

    Usage::

        cfg = SolverConfig(grid=GridConfig.cube(128))
        solver = HeatSolver3D(cfg)             # on cuda
        u = solver.init_state("hot-cube")
        u = solver.run(u, num_steps=100)

    ``taps`` overrides the config's update taps (``carry.taps_from_reference``
    hands over the JAX package's taps). ``run``/``run_to_convergence``
    consume their input field (its buffer is reused), as the JAX package's
    donated executables do; keep a ``clone()`` to reuse it.
    """

    def __init__(
        self,
        cfg: SolverConfig,
        device: Union[str, torch.device, None] = None,
        taps: Optional[np.ndarray] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.taps = _solver_taps(cfg) if taps is None else np.asarray(
            taps, dtype=np.float64
        )
        self._pp = PingPong()
        self._pads = PadBuffers()
        self._compute = _select_backend(cfg)
        self._step = make_step_fn(cfg, self.taps, False, self._compute, self._pads)
        self._step_res = make_step_fn(cfg, self.taps, True, self._compute, self._pads)
        self._converge = make_converge_fn(
            cfg, self.taps, self._pp, self._compute, self._pads
        )
        # built on first use, as in the JAX package: the superstep's extent
        # check belongs to the fixed-step loop
        self._multistep_cache = None

    @property
    def _multistep(self):
        if self._multistep_cache is None:
            self._multistep_cache = make_multistep_fn(
                self.cfg, self.taps, self._pp, self._compute, self._pads
            )
        return self._multistep_cache

    @property
    def storage_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.precision.storage)

    # ---- state -----------------------------------------------------------

    def init_state(
        self, init: Union[str, np.ndarray] = "hot-cube"
    ) -> torch.Tensor:
        """The initial field on the device. ``hot-cube`` is built on the
        device (its values 0 and 1 are exact in every storage dtype); the
        other named initializers come from ``core.golden.make_init_block``
        (float32, then rounded to storage), so they are byte-equal to the
        JAX package's; an array is used as given."""
        shape = self.cfg.grid.shape
        if isinstance(init, np.ndarray):
            if init.shape != shape:
                raise ValueError(f"init shape {init.shape} != grid {shape}")
            # a copy: run() consumes its input, which must not be the
            # caller's array
            return torch.from_numpy(np.array(init)).to(
                self.device, self.storage_dtype
            )
        if init == "hot-cube":
            return self._hot_cube()
        block = golden.make_init_block(
            init, shape, tuple(slice(0, n) for n in shape),
            seed=self.cfg.run.seed,
        )
        return torch.from_numpy(block).to(self.device).to(self.storage_dtype)

    def _hot_cube(self) -> torch.Tensor:
        u = torch.zeros(self.cfg.grid.shape, dtype=self.storage_dtype,
                        device=self.device)
        sl = []
        for n in self.cfg.grid.shape:
            # same bounds arithmetic as golden.make_init_block
            g0 = int(n * (0.5 - 0.25 / 2))
            g1 = max(int(n * (0.5 + 0.25 / 2)), g0 + 1)
            sl.append(slice(g0, g1))
        u[tuple(sl)] = 1.0
        return u

    def zeros_state(self) -> torch.Tensor:
        return torch.zeros(self.cfg.grid.shape, dtype=self.storage_dtype,
                           device=self.device)

    # ---- stepping --------------------------------------------------------

    def step(self, u: torch.Tensor) -> torch.Tensor:
        return self._step(u)

    def step_with_residual(
        self, u: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update and the float32 sum of squared changes (a 0-d tensor
        on the device; sqrt of it is the L2 residual)."""
        return self._step_res(u)

    def run(self, u: torch.Tensor, num_steps: int) -> torch.Tensor:
        """``num_steps`` updates (time_blocking k > 1: ``num_steps // k``
        supersteps, then the remainder as single steps). Consumes ``u``."""
        return self._multistep(u, int(num_steps))

    def run_to_convergence(
        self, u: torch.Tensor, tol: float, max_steps: int
    ) -> RunResult:
        u, steps, res = self._converge(u, int(max_steps), float(tol))
        return RunResult(u=u, steps=steps, residual=res)

    # ---- IO --------------------------------------------------------------

    def gather(self, u: torch.Tensor) -> np.ndarray:
        """The field on the host. bf16 storage comes back as float32 (NumPy
        has no bfloat16; the conversion is exact)."""
        if u.dtype == torch.bfloat16:
            u = u.float()
        return u.detach().cpu().numpy()
