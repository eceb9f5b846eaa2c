"""``cli.train_vto --tensor_parallel 2`` over two gloo ranks on the CPU
(data 1 x model 2): the checks of ``test_torch_port_parallel_mains.py``
(two steps, a bitwise resume from ``checkpoint-1``, the first loss
against the single process's, the gathered ``unet_{step}.pth`` through
both zoos), with the validation images sampled by the tensor-parallel
UNet."""

from test_torch_port_parallel_mains import (  # noqa: F401 - fixtures
    check_two_ranks,
    single,
    tree,
)


def test_train_vto_tensor_parallel_over_two_ranks(tree, tmp_path, single,
                                                  monkeypatch):
    check_two_ranks(tree, tmp_path, ["--tensor_parallel", "2"], single,
                    monkeypatch)
