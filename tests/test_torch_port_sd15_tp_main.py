"""``cli.train_vto --tensor_parallel 2`` over two gloo ranks on the CPU
(data 1 x model 2) on an SD-1.5 model directory in the eight-head form
(``test_torch_port_sd15_train_main.write_sd15_tree``: ``"head_dim": -1``,
1x1-conv projections, a quick_gelu text tower): the checks of
``test_torch_port_parallel_mains.py`` (two steps, a bitwise resume from
``checkpoint-1``, the first loss against the single process's, the
gathered ``unet_{step}.pth`` through both zoos), with the validation
images sampled by the tensor-parallel UNet, every attention of which
holds four of its eight heads on each rank."""

import json

import pytest

from test_torch_port_parallel_mains import (  # noqa: F401 - fixture
    check_two_ranks,
    single,
)
from test_torch_port_sd15_train_main import write_sd15_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_sd15_tree(tmp_path_factory.mktemp("sd15_tp_tree"),
                           "eight-heads")


def test_sd15_train_vto_tensor_parallel_over_two_ranks(tree, tmp_path,
                                                       single, monkeypatch):
    check_two_ranks(tree, tmp_path, ["--tensor_parallel", "2"], single,
                    monkeypatch)
    side = json.loads((tmp_path / "full" / "unet_2.config.json").read_text())
    assert (side["head_dim"], side["use_linear_projection"]) == (-1, False)
