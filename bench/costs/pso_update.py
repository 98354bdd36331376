"""pso_update (Eq. 8 over a stacked (W, *leaf) leaf): operations and
bytes of one launch. Frozen copy of the port's definition
(kernels/pso_update/ops.py `_pso_cost`)."""


def pso_update(W: int, leaf_numel: int, elem: int) -> tuple[int, int]:
    """8 operations an element of the W stacked leaves; w, v, w^l, d in
    and w', v' out, w^g once, the (W, 4) f32 coefficients."""
    n = W * leaf_numel
    return 8 * n, elem * (6 * n + leaf_numel) + 16 * W
