"""The flash-attention forward and backward: operations and bytes of one
launch. Frozen copy of the port's definitions
(kernels/flash_attention/ops.py `_forward_cost`, `_bwd_cost`,
`visited_pairs`): the operations count the (query, key) pairs the mask
lets through, 4 hd a pair forward (two products) and 10 hd backward
(five); the bytes read each input once and write each output once."""


def visited_pairs(Sq: int, Sk: int, causal: bool, window: int = 0,
                  q_offset: int | None = None,
                  kv_len: int | None = None) -> int:
    """(query, key) pairs inside the mask, for one batch row and head."""
    q_offset = Sk - Sq if q_offset is None else q_offset
    kv_len = Sk if kv_len is None else kv_len
    total = 0
    for i in range(Sq):
        pos = q_offset + i
        hi = min(kv_len, Sk)
        if causal:
            hi = min(hi, pos + 1)
        lo = max(pos - window + 1, 0) if window else 0
        total += max(hi - lo, 0)
    return total


def forward(B: int, Sq: int, Sk: int, H: int, K: int, hd: int,
            elem: int, causal: bool, lse: bool) -> tuple[int, int]:
    """q read, out written, k and v read once, the f32 (B, H, Sq)
    log-sum-exp written when a backward follows."""
    pairs = B * H * visited_pairs(Sq, Sk, causal)
    q = B * Sq * H * hd * elem
    kv = B * Sk * K * hd * elem
    return 4 * hd * pairs, 2 * q + 2 * kv + (4 * B * Sq * H if lse else 0)


def backward(B: int, Sq: int, Sk: int, H: int, K: int, hd: int,
             elem: int, causal: bool) -> tuple[int, int]:
    """q, out, dout read and dq written; k, v read and dk, dv written;
    the f32 log-sum-exp read."""
    pairs = B * H * visited_pairs(Sq, Sk, causal)
    q = B * Sq * H * hd * elem
    kv = B * Sk * K * hd * elem
    return 10 * hd * pairs, 4 * q + 4 * kv + 4 * B * H * Sq
