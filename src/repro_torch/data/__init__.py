from repro_torch.data.partition import (FederatedData, dirichlet_partition,
                                        iid_partition,
                                        mixed_dirichlet_partition)
from repro_torch.data.synthetic import (CIFAR_LIKE, MNIST_LIKE,
                                        SyntheticImageSpec,
                                        make_class_prototypes,
                                        sample_labels_dirichlet)
