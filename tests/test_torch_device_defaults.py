"""The paper path's builders run on the card unless the caller names a
device: with no card and no device they raise (`runtime.resolve_device`),
never falling back to the CPU on their own; with device="cpu" they build
there."""
import pytest
import torch

from repro_torch.configs.paper_cnn import paper_cnn, paper_resnet
from repro_torch.data import partition
from repro_torch.data.synthetic import CIFAR_LIKE, MNIST_LIKE
from repro_torch.experiments import runner
from repro_torch.models.cnn import make_cnn5, make_resnet

BUILDERS = {
    "make_cnn5": lambda **k: make_cnn5(28, 28, 1, 10, 2, **k),
    "make_resnet": lambda **k: make_resnet(32, 32, 3, 10, 2, **k),
    "paper_cnn": lambda **k: paper_cnn(MNIST_LIKE, 2, **k),
    "paper_resnet": lambda **k: paper_resnet(CIFAR_LIKE, 2, **k),
    "iid_partition": lambda **k: partition.iid_partition(
        0, 2, MNIST_LIKE, 4, 8, 8, **k),
    "dirichlet_partition": lambda **k: partition.dirichlet_partition(
        0, 2, 0.5, MNIST_LIKE, 4, 8, 8, **k),
    "mixed_dirichlet_partition": lambda **k: (
        partition.mixed_dirichlet_partition(0, [(1, 0.1), (1, 10.0)],
                                            MNIST_LIKE, 4, 8, 8, **k)),
    "make_case_data": lambda **k: runner.make_case_data(
        "noniid1", "mnist_like", 2, 0, 4, **k)[0],
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_no_card_and_no_device_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BUILDERS[name]()


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_explicit_cpu_builds_there(name):
    out = BUILDERS[name](device="cpu")
    if hasattr(out, "init"):
        out = out.init(torch.Generator().manual_seed(0))
        leaf = next(iter(out.values()))
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf
        assert leaf.device.type == "cpu"
    else:
        assert out.x.device.type == "cpu" and out.y.device.type == "cpu"
