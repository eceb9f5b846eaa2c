"""The SD-1.5 VTO step with gradient accumulation (A = 2) against the JAX
accumulating step, on the CPU, in both forms
(``test_torch_port_sd15_train.check_vto_step``'s ``"accumulation-2"``:
the adapter trained on the warped cloth, micro-batch i drawing from
``split(rng, A)[i]`` as the JAX scan does; the loss within ``LOSS_RTOL``
and every gradient within ``GRAD_RTOL``).  A file of its own so that each
of the SD-1.5 files stays under a minute."""

from test_torch_port_sd15_train import (  # noqa: F401 - fixtures
    check_vto_step,
    form_towers,
    shared,
)


def test_sd15_accumulating_step_matches_jax(form_towers):
    check_vto_step(form_towers, "accumulation-2")
