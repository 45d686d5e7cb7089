"""The plain reference against a float64 NumPy Dirichlet update at 16^3."""

import numpy as np
import pytest
import torch

from portbench import cells
from portbench.reference.heat import Reference, taps

BENCH = cells.load_benchmark()


def numpy_steps(u, t, steps, bc=0.0):
    u = u.astype(np.float64)
    n = u.shape
    for _ in range(steps):
        p = np.pad(u, 1, constant_values=bc)
        new = np.zeros(n)
        for (i, j, k), w in np.ndenumerate(t):
            new += w * p[i:i + n[0], j:j + n[1], k:k + n[2]]
        u = new
    return u


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
@pytest.mark.parametrize("steps", [1, 5])
def test_reference_equals_numpy(name, steps):
    config = cells.config(BENCH, name)
    shape = (16, 15, 17)
    u = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = numpy_steps(u, taps(config), steps)
    ref = Reference(config, "cpu", torch.float64, shape)
    got, _ = ref.run(torch.from_numpy(u).double(), steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    ref32 = Reference(config, "cpu", torch.float32, shape)
    got32, r = ref32.run(torch.from_numpy(u), steps, residual_dtype=torch.float64)
    np.testing.assert_allclose(got32.numpy(), want, rtol=0, atol=1e-5)
    prev = numpy_steps(u, taps(config), steps - 1)
    assert r == pytest.approx(np.sqrt(((want - prev) ** 2).sum()), rel=1e-4)


def test_taps_are_the_heat_update():
    for c in BENCH["configs"]:
        config = cells.config(BENCH, c["name"])
        t = taps(config)
        assert t.sum() == pytest.approx(1.0, abs=1e-12)  # a constant field stays
        assert t[1, 1, 1] == pytest.approx(
            1 - config["dt"] * (6.0 if config["stencil"] == "7pt" else 64 / 15))
