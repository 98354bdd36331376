"""The paper's own experimental models (§V-A): the 5-layer CNN [9] and a
compact ResNet on (synthetic) MNIST/CIFAR10-like data."""
from repro_torch.data.synthetic import CIFAR_LIKE, MNIST_LIKE
from repro_torch.models.cnn import make_cnn5, make_resnet


def paper_cnn(spec=MNIST_LIKE, width_mult: int = 8, device=None):
    return make_cnn5(spec.height, spec.width, spec.channels,
                     spec.num_classes, width_mult, device=device)


def paper_resnet(spec=CIFAR_LIKE, width_mult: int = 8, device=None):
    return make_resnet(spec.height, spec.width, spec.channels,
                       spec.num_classes, width_mult, device=device)
