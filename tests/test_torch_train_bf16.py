"""The port's training path in bf16, the configs' own type, against the
reference (``test_torch_train_step.bf16_check``): loss and every gradient
no farther from the reference's float32 run than twice the reference's own
bf16 run, plus 1e-3 of the loss and 1e-2 of max |grad| per leaf, from the
same float32 parameters.  Measured worst leaf, the port's distance over that
bound: 0.87 Zamba2, 0.59 Mamba2, 0.53 GLM-4, 0.50 Nemotron.  The reference's
own bf16 gradients are 2 to 47% of max |grad| from its float32 ones on these
configs (Mamba2's A_log and dt_bias at the reference's init, dt_bias 0,
ROADMAP F5), so a fixed tolerance against its bf16 run would say nothing.
"""

import pytest
from repro.distrib.context import set_mesh
from test_torch_train_step import bf16_check


@pytest.fixture(scope="module", autouse=True)
def _no_mesh():
    set_mesh(None)
    yield


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-370m", "glm4-9b", "nemotron-4-15b"])
def test_bf16_near_reference(arch):
    bf16_check(arch)
