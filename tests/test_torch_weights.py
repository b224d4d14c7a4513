"""The port's imaging-density weights (``ops/weights.py``) against the JAX
package's: the density grid, the RMS and the normalised RMS to 1e-6
relative (f32 sums in another order), for natural, uniform and robust
weighting, and the drop of cells outside the grid."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu.ops import weights as jax_weights
from katsdpimager_tpu_torch.ops import weights

N, P = 64, 2


def _blocks(seed):
    """Two blocks of (uv, weights), some cells past the grid's far edge
    (dropped by both; JAX's scatter wraps NEGATIVE indices before its
    drop, so none are drawn)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (3000, 1700):
        uv = np.clip(rng.normal(scale=N / 5, size=(n, 2)), -N // 2,
                     N // 2 - 1).astype(np.int16)
        uv[:20] = N // 2
        wt = rng.uniform(0.5, 2.0, size=(n, P)).astype(np.float32)
        out.append((uv, wt))
    return out


@pytest.mark.parametrize("kind,robustness", [
    ("NATURAL", 0.0), ("UNIFORM", 0.0), ("ROBUST", 0.0), ("ROBUST", 1.5)])
def test_weights_match_jax(kind, robustness):
    jw = jax_weights.Weights(jax_weights.WeightType[kind], P, N, robustness)
    tw = weights.Weights(weights.WeightType[kind], P, N, robustness)
    for uv, wt in _blocks(3):
        jw.accumulate(jnp.asarray(uv), jnp.asarray(wt))
        tw.accumulate(uv, wt)
    jr, jn = jw.finalize()
    tr, tn = tw.finalize()
    np.testing.assert_allclose(tw.grid.numpy(), np.asarray(jw.grid),
                               rtol=1e-6)
    assert tn == pytest.approx(jn, rel=1e-6)
    if kind == "NATURAL":
        assert tr is None and jr is None
    else:
        assert tr == pytest.approx(jr, rel=1e-6)


def test_grid_weights_drops_outside_cells():
    grid = torch.zeros((1, 8, 8))
    uv = torch.tensor([[0, 0], [4, 0], [-5, 1], [3, 3]], dtype=torch.int16)
    w = torch.ones((4, 1))
    weights.grid_weights(grid, uv, w)
    assert grid.sum().item() == 2.0
    assert grid[0, 4, 4].item() == 1.0 and grid[0, 7, 7].item() == 1.0
