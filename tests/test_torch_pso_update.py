"""The port's fused PSO update (paper Eq. 8) — its plain version, the CPU
dispatch of `repro_torch.kernels.pso_update.ops.pso_update` and the
oracle the CUDA kernel is held to bitwise on the card — against the JAX
package on the same numpy inputs.

Tolerances:
  * f32, against `pso_update_ref` and `pso_update_2d(interpret=True)`
    (through the JAX wrapper's padding), one worker at a time: within
    F32_ULPS ulps of the sum of the update's term magnitudes
    |c0 v| + |c1 (wl - w)| + |c2 (wg - w)| + |d| (+ |w| for w'); XLA may
    contract a product and a sum into an FMA where the port rounds both,
    and the measured worst case is 2.0;
  * bf16, against the reference's inline leaf (`core/swarm_dist.py`
    local_round, vmapped over the workers): within one bf16 ulp of v'
    and of w' when XLA compiles it with excess precision off (every bf16
    value rounded where the program says, the rounding points the port
    follows; a contracted f32 sum can flip a rounding near a bf16
    midpoint, measured in 3-4 of 99,000 elements); with XLA's
    default excess precision (wl - w and wg - w kept in f32) within the
    bound that difference implies: |c1| and |c2| times half a bf16 ulp
    of the differences, plus one bf16 ulp of v' (and, for w', one more
    of w').
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pso_update.ops import pso_update as jpso_update
from repro.kernels.pso_update.pso_update import pso_update_2d
from repro.kernels.pso_update.ref import pso_update_ref as jpso_update_ref
from repro_torch.bridge import array_to_tensor
from repro_torch.kernels import runtime
from repro_torch.kernels.pso_update import ops, ref

F32_ULPS = 2.0
W = 3


def _inputs(seed, n, dtype=np.float32):
    rng = np.random.default_rng(seed)

    def a(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    w, v, wl, d = a((W, n), 0.1), a((W, n), 0.01), a((W, n), 0.1), \
        a((W, n), 1e-3)
    wg = a((n,), 0.1)
    c = np.concatenate([rng.uniform(size=(W, 1)),
                        rng.standard_normal((W, 2))], 1).astype(np.float32)
    return c, w, v, wl, wg, d


def _coefs(c, clip):
    return np.concatenate([c, np.full((W, 1), clip, np.float32)], 1)


def _term_scale(co, w, v, wl, wg, d):
    return (np.abs(co[:, :1] * v) + np.abs(co[:, 1:2] * (wl - w))
            + np.abs(co[:, 2:3] * (wg - w)) + np.abs(d))


def _within_ulps(got, want, scale, ulps, what):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    worst = float(np.max(err / np.spacing(scale.astype(np.float32))))
    assert worst <= ulps, f"{what}: {worst} ulps of the term scale"


@pytest.mark.parametrize("clip", [0.0, 1.0, 0.02])
@pytest.mark.parametrize("n", [1, 1001, 33000])
def test_plain_matches_jax_ref_and_pallas_f32(n, clip):
    c, w, v, wl, wg, d = _inputs(n, n)
    co = _coefs(c, clip)
    tw, tv = ops.pso_update(torch.from_numpy(co),
                            *(torch.from_numpy(x) for x in (w, v, wl, wg, d)))
    assert tw.dtype == tv.dtype == torch.float32
    assert tuple(tw.shape) == tuple(tv.shape) == (W, n)
    sv = _term_scale(co, w, v, wl, wg, d)
    sw = sv + np.abs(w)
    ref_fn = jax.jit(jpso_update_ref)
    for i in range(W):
        jw, jv = ref_fn(jnp.asarray(co[i]), w[i], v[i], wl[i], wg, d[i])
        _within_ulps(tv[i], jv, sv[i], F32_ULPS, f"v' vs ref, worker {i}")
        _within_ulps(tw[i], jw, sw[i], F32_ULPS, f"w' vs ref, worker {i}")
        # the Pallas kernel in interpret mode, through the JAX wrapper
        # that pads the flat leaf to (rows, 128) blocks
        pw, pv = jpso_update(w[i], v[i], wl[i], wg, d[i], co[i, 0],
                             co[i, 1], co[i, 2], clip, interpret=True)
        _within_ulps(tv[i], pv, sv[i], F32_ULPS, f"v' vs pallas, worker {i}")
        _within_ulps(tw[i], pw, sw[i], F32_ULPS, f"w' vs pallas, worker {i}")
        if clip > 0:
            assert float(tv[i].abs().max()) <= clip


def test_pallas_block_layout_matches_plain():
    """`pso_update_2d` on its own (rows, 128) layout, one worker."""
    c, w, v, wl, wg, d = _inputs(7, 256 * 128)
    co = _coefs(c, 0.5)
    tw, tv = ref.pso_update_ref(torch.from_numpy(co), *(
        torch.from_numpy(x) for x in (w, v, wl, wg, d)))
    sv = _term_scale(co, w, v, wl, wg, d)
    for i in range(W):
        pw, pv = pso_update_2d(jnp.asarray(co[i]), *(
            jnp.asarray(x.reshape(-1, 128))
            for x in (w[i], v[i], wl[i], wg, d[i])), interpret=True)
        _within_ulps(tv[i], np.asarray(pv).reshape(-1), sv[i], F32_ULPS,
                     f"v' worker {i}")
        _within_ulps(tw[i], np.asarray(pw).reshape(-1), sv[i] + np.abs(w[i]),
                     F32_ULPS, f"w' worker {i}")


def _inline_leaf(clip):
    """The reference's Eq.-8 leaf (core/swarm_dist.py local_round), per
    worker; vmapped over W with per-worker coefficients."""
    def leaf(w, v, wl, wg, d, c0, c1, c2):
        v_new = c0 * v + c1 * (wl - w) + c2 * (wg - w) + d
        if clip > 0:
            v_new = jnp.clip(v_new, -clip, clip)
        v_new = v_new.astype(w.dtype)
        return jnp.add(w, v_new), v_new
    return jax.vmap(leaf, in_axes=(0, 0, 0, None, 0, 0, 0, 0))


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("clip", [0.0, 1.0, 0.02])
@pytest.mark.parametrize("n", [1001, 33000])
def test_plain_matches_inline_leaf_bf16(n, clip):
    c, *xs = _inputs(n + 1, n)
    co = _coefs(c, clip)
    w, v, wl, wg, d = (jnp.asarray(x, jnp.bfloat16) for x in xs)
    args = (w, v, wl, wg, d, *(jnp.asarray(co[:, i]) for i in range(3)))
    tw, tv = ops.pso_update(torch.from_numpy(co), *(
        array_to_tensor(np.asarray(x)) for x in (w, v, wl, wg, d)))
    assert tw.dtype == tv.dtype == torch.bfloat16
    tvf, twf = tv.float().numpy(), tw.float().numpy()

    def ulp_of(a, b):
        return _bf16_ulp(np.maximum(np.abs(a), np.abs(b)))

    f = jax.jit(_inline_leaf(clip))
    # the program's own rounding points: within one bf16 ulp of v' and
    # w' (the f32 sums may round differently where XLA contracts, which
    # flips a bf16 rounding near a midpoint)
    strict = f.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    sw, sv = (np.asarray(t, np.float32) for t in strict(*args))
    assert np.all(np.abs(tvf - sv) <= ulp_of(tvf, sv))
    assert np.all(np.abs(twf - sw) <= ulp_of(twf, sw))
    # XLA's default: the differences stay in f32
    jw, jv = (np.asarray(t, np.float32) for t in f(*args))
    wf, wlf, wgf = (np.asarray(x, np.float32) for x in (w, wl, wg))
    half = 0.5 * (np.abs(co[:, 1:2]) * _bf16_ulp(wlf - wf)
                  + np.abs(co[:, 2:3]) * _bf16_ulp(wgf - wf))
    bound_v = half + ulp_of(jv, tvf)
    assert np.all(np.abs(tvf - jv) <= bound_v)
    # w' = w + v' carries v''s difference, plus its own rounding
    assert np.all(np.abs(twf - jw) <= bound_v + ulp_of(jw, twf))


def test_cpu_wrapper_takes_plain_path_and_counts_nothing():
    c, w, v, wl, wg, d = _inputs(3, 4 * 5 * 7)
    shape = (W, 4, 5, 7)
    t = [torch.from_numpy(x) for x in (w, v, wl, d)]
    co = torch.from_numpy(_coefs(c, 1.0))
    runtime.reset_counts()
    gw, gv = ops.pso_update(co, *(x.reshape(shape) for x in t[:3]),
                            torch.from_numpy(wg).reshape(shape[1:]),
                            t[3].reshape(shape))
    assert runtime.counts() == {}
    pw, pv = ref.pso_update_ref(co, *t[:3], torch.from_numpy(wg), t[3])
    assert tuple(gw.shape) == shape
    assert torch.equal(gw.reshape(W, -1), pw)
    assert torch.equal(gv.reshape(W, -1), pv)
    # meta tensors get the operator's shape rule and launch nothing; the
    # kernel's launch itself takes CUDA tensors only
    meta = (co.to("meta"), *(x.to("meta") for x in t[:3]),
            torch.from_numpy(wg).to("meta"), t[3].to("meta"))
    mw, mv = ops.pso_update(*meta)
    assert mw.device.type == "meta" and mw.shape == meta[1].shape
    assert mv.shape == meta[2].shape and runtime.counts() == {}
    with pytest.raises(ValueError, match="no kernel"):
        ops._pso_cuda(*meta)
