"""The port's ``train_emasc`` main on ``--device cpu``: the checks of
``test_torch_port_train_mains.py`` (three steps and keep-2 GC, the losses
bitwise equal to the direct step loop, a bitwise resume from latest, the
export through both zoos) over the DressCode train split of every
category, with a torchvision-layout VGG19."""

import pytest
import torch

from test_torch_port_train_mains import check_main, write_train_tree

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_train_tree(tmp_path_factory.mktemp("emasc_tree"))


def test_main_trains_checkpoints_resumes_and_exports(tree, tmp_path,
                                                     monkeypatch):
    check_main(tree, tmp_path, "emasc", monkeypatch)
