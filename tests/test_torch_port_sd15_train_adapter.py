"""The SD-1.5 VTO step with the inversion adapter trained against the JAX
step, on the CPU, in both forms: ``test_torch_port_sd15_train``'s check in
the ``VTO_CASES`` cases that train the adapter (the loss within
``LOSS_RTOL``, every UNet and adapter gradient within ``GRAD_RTOL``).  A
file of its own so that each of the SD-1.5 files stays under a minute."""

import pytest

from test_torch_port_sd15_train import (  # noqa: F401 - fixtures
    check_vto_step,
    form_towers,
    shared,
)
from test_torch_port_train_steps import VTO_CASES


@pytest.mark.parametrize("case", sorted(c for c, v in VTO_CASES.items()
                                        if v[2]))
def test_sd15_vto_step_trains_the_adapter_as_jax(form_towers, case):
    check_vto_step(form_towers, case)
