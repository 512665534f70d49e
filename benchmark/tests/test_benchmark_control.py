"""On the card: the control (the reference put in the program's place in
TF32, the precision below the configuration's f32 with TF32 off) and the
planted faults (one reading for each leaf left unchanged by Adam among
them) come out not correct under each cell's limits, at the cell's own
size, on a seed of their own.  Run on the card:

    python3 -m pytest benchmark/tests -m gpu
"""

import pytest
import torch

from benchmark import control, run
from benchmark.tests.tiny import CELLS


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32 on the card")
    spec = run.cell_spec(cell)
    got = control.control_gaps(spec, 2**31 + 17, torch.device("cuda", 0))
    runs = {v: got[v] for v in control.VARIANTS if v != "fault_frozen_leaf"}
    runs.update({f"frozen {leaf}": r for leaf, r in
                 got["fault_frozen_leaf"].items()})
    for v, r in runs.items():
        over = {k: r["gaps"][k] for k, lim in spec.limits.items()
                if r["gaps"][k] > lim}
        assert over, (v, r["gaps"], spec.limits)
