"""The harness on the card at the small size: the kernels' route through
each runner, compared with the reference.  Skipped without a CUDA
device; on the card:

    python -m pytest portbench/tests/test_portbench_gpu.py -q
"""

import pytest
import torch

from portbench import run
from portbench.tests.small import SEED, small_cell, wave_cell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("make", [small_cell, wave_cell],
                         ids=["dirty", "wave"])
def test_small_cells_on_the_card(cuda, make):
    out = run.run_cell(make(), seed=SEED, seconds=1.0, trace=True,
                       device="cuda")
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert out["metrics"]
