"""The port's ``core.config`` and ``utils.profiling`` against the JAX
package's modules.

The five configuration dataclasses have the JAX module's fields, in its
order, with its defaults; ``DataConfig.dataroot`` picks and refuses as
it does; ``DebugConfig.apply`` turns on autograd's anomaly detection.
``Throughput`` counts the images it is given and their rate; ``trace``
writes a ``torch.profiler`` trace with an ``annotate`` span in it.
"""

import dataclasses

import pytest
import torch

from ladi_vton_tpu.core import config as jax_config
from ladi_vton_tpu_torch.core import config
from ladi_vton_tpu_torch.utils import profiling

NAMES = ("DataConfig", "WeightsConfig", "GenerationConfig", "TrainConfig",
         "DebugConfig")


def _fields(cls) -> list:
    return [(f.name, f.default, f.default_factory)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", NAMES)
def test_fields_and_defaults_equal_the_jax_module(name):
    assert _fields(getattr(config, name)) == _fields(
        getattr(jax_config, name))


def test_dataroot_follows_the_dataset():
    for mod in (config, jax_config):
        assert mod.DataConfig(vitonhd_dataroot="/v").dataroot == "/v"
        assert mod.DataConfig(dataset="dresscode",
                              dresscode_dataroot="/d").dataroot == "/d"
        with pytest.raises(ValueError, match="dataroot must be provided"):
            mod.DataConfig(dataset="dresscode").dataroot


def test_debug_nans_turns_on_anomaly_detection():
    before = torch.is_anomaly_enabled()
    try:
        config.DebugConfig().apply()
        assert torch.is_anomaly_enabled() == before
        config.DebugConfig(debug_nans=True).apply()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_throughput_counts_images():
    meter = profiling.Throughput()
    meter.start()
    meter.add(torch.ones(3, 4), 3)
    meter.add({"images": torch.zeros(2)}, 2)
    assert meter.images == 5
    assert meter.images_per_sec > 0


def test_trace_writes_a_profile_with_the_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("ladi_span"):
            torch.ones(8).sum()
    traces = list(tmp_path.rglob("*.json"))
    assert traces and "ladi_span" in traces[0].read_text()
    with profiling.trace(None):  # a no-op
        pass
