"""The worker-batched 3x3 "SAME" convolution (`kernels/worker_conv`):
its plain versions bitwise against what `torch.func.vmap` makes of
`F.conv2d` and its autograd (the model's convolution before the
kernel), the routing in `models/cnn._conv`, the shape rules and the costs on
the CPU; the CUDA kernel against the plain versions at the main path's
shapes, its launch plans and the models' routing by them on the card
(`-m card`)."""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core import mdsl
from repro_torch.experiments import runner
from repro_torch.kernels import runtime
from repro_torch.kernels.worker_conv import ops
from repro_torch.kernels.worker_conv.ref import (worker_conv_dgrad_ref,
                                                 worker_conv_ref,
                                                 worker_conv_wgrad_ref)
from repro_torch.models import cnn
from repro_torch.pytree import tree_leaves, tree_map

# CNN5 at width x8 on 28 x 28 x 1 images: (Cin, Cout, H = W)
LAYERS = {"conv1": (1, 8, 28), "conv2": (8, 16, 14), "conv3": (16, 16, 7)}


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _params(C, cin, cout, gen):
    return {"w": torch.randn((C, 3, 3, cin, cout), generator=gen),
            "b": torch.randn((C, cout), generator=gen)}


def _old_conv(p, x):
    """The model's convolution before the kernel (cnn._conv on the CPU)."""
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding=1) + \
        p["b"].reshape(-1, 1, 1)


def _new_conv(p, x):
    return ops.worker_conv(x, p["w"], p["b"])


def _layer_loss(conv):
    def loss(p, x, r):
        return (F.relu(conv(p, x)) * r).sum()
    return loss


@pytest.mark.parametrize("argnums", [(0, 1), (0,)])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_plain_bitwise_vmapped_conv_under_grad(two_threads, C, layer,
                                               argnums):
    """vmap(grad) over the workers: the forward, the input gradient and
    the weight and bias gradients of the operator's plain versions are
    the vmapped F.conv2d's, bit for bit; with argnums (0,) no input
    gradient is formed (conv1, whose input is the images)."""
    cin, cout, hw = LAYERS[layer]
    gen = torch.Generator().manual_seed(7 + C)
    p = _params(C, cin, cout, gen)
    x = torch.randn((C, 5, cin, hw, hw), generator=gen)
    r = torch.randn((C, 5, cout, hw, hw), generator=gen)
    outs = []
    for conv in (_old_conv, _new_conv):
        y = torch.func.vmap(conv)(p, x)
        g = torch.func.vmap(torch.func.grad(_layer_loss(conv),
                                            argnums=argnums))(p, x, r)
        outs.append((y, g + (None,) * (2 - len(g))))
    (y0, (gp0, gx0)), (y1, (gp1, gx1)) = outs
    assert torch.equal(y0, y1)
    assert gx0 is gx1 is None or torch.equal(gx0, gx1)
    assert torch.equal(gp0["w"], gp1["w"])
    assert torch.equal(gp0["b"], gp1["b"])


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_plain_bitwise_vmapped_conv_shared_input(two_threads, C, layer):
    """eval_stacked's vmap under no_grad with one input every worker
    reads (in_dims None): bitwise the vmapped F.conv2d."""
    cin, cout, hw = LAYERS[layer]
    gen = torch.Generator().manual_seed(11 + C)
    p = _params(C, cin, cout, gen)
    x = torch.randn((6, cin, hw, hw), generator=gen)
    r = torch.randn((6, cout, hw, hw), generator=gen)
    got = [mdsl.eval_stacked(_layer_loss(conv), p, x, r)
           for conv in (_old_conv, _new_conv)]
    assert torch.equal(*got)
    with torch.no_grad():
        ys = [torch.func.vmap(conv, in_dims=(0, None))(p, x)
              for conv in (_old_conv, _new_conv)]
    assert torch.equal(*ys)


def _route_on_cpu(monkeypatch) -> list:
    """`_conv` taking the operator on the CPU (its plain versions), as it
    does on the card; returns the list of (taken, kernel, stride) of the
    convolutions it routes."""
    seen = []
    takes = ops.takes
    monkeypatch.setattr(ops, "on_card", lambda x: True)
    monkeypatch.setattr(ops, "fits", lambda *shape: True)

    def record(x, w, stride):
        ok = takes(x, w, stride)
        seen.append((ok, tuple(w.shape[:2]), stride))
        return ok

    monkeypatch.setattr(ops, "takes", record)
    return seen


@pytest.mark.parametrize("C", [1, 3])
def test_cnn5_routed_bitwise(two_threads, monkeypatch, C):
    """CNN5's loss gradients under vmap(grad) and its scoring under
    eval_stacked, all three convolutions through the operator: bitwise
    the model's F.conv2d path."""
    model = cnn.make_cnn5(28, 28, 1, 10, width_mult=8, device="cpu")
    gen = torch.Generator().manual_seed(3)
    params = tree_map(lambda v: v + 0.01 * torch.randn((C,) + v.shape,
                                                       generator=gen),
                      model.init(gen))
    x = torch.randn((C, 8, 28, 28, 1), generator=gen)
    y = torch.randint(0, 10, (C, 8), generator=gen)

    def loss(p, xb, yb):
        return F.cross_entropy(model.apply(p, xb), yb)

    def run():
        return (torch.func.vmap(torch.func.grad(loss))(params, x, y),
                mdsl.eval_stacked(loss, params, x[0], y[0]))

    g0, s0 = run()
    seen = _route_on_cpu(monkeypatch)
    g1, s1 = run()
    assert torch.equal(s0, s1)
    for k in g0:
        for kk in g0[k]:
            assert torch.equal(g0[k][kk], g1[k][kk]), (k, kk)
    # three convolutions a forward, in the gradient and the scoring
    assert seen == [(True, (3, 3), 1)] * 6


def test_resnet_routes_stride2_and_1x1_to_conv2d(two_threads, monkeypatch):
    """ResNet: its 3x3 stride-1 convolutions take the operator; the
    stride-2 ones and the 1x1 projections stay F.conv2d."""
    model = cnn.make_resnet(16, 16, 3, 10, width_mult=4, device="cpu")
    gen = torch.Generator().manual_seed(5)
    params = model.init(gen)
    seen = _route_on_cpu(monkeypatch)
    out = model.apply(params, torch.randn((2, 16, 16, 3), generator=gen))
    assert out.shape == (2, 10)
    taken = [(k, s) for ok, k, s in seen if ok]
    left = [(k, s) for ok, k, s in seen if not ok]
    # stem, s0b0 a and b, s0b1 a and b, s1b0 b, s1b1 a and b
    assert taken == [((3, 3), 1)] * 8
    assert sorted(left) == [((1, 1), 2), ((3, 3), 2)]


def test_takes(monkeypatch):
    """The kernel takes 3x3 stride-1 f32 convolutions on the card only,
    where its plans fit."""
    w = torch.zeros((3, 3, 4, 8))
    x = torch.zeros((2, 4, 7, 7))
    assert not ops.takes(x, w, 1)                 # on the CPU
    assert not ops.takes(x.to("meta"), w.to("meta"), 1)
    monkeypatch.setattr(ops, "on_card", lambda x: True)
    monkeypatch.setattr(ops, "fits", lambda *shape: False)
    assert not ops.takes(x, w, 1)
    monkeypatch.setattr(ops, "fits", lambda *shape: True)
    assert ops.takes(x, w, 1)
    assert not ops.takes(x, w, 2)
    assert not ops.takes(x, w[:1, :1], 1)
    assert not ops.takes(x.double(), w.double(), 1)
    assert not ops.takes(x.to(torch.bfloat16), w.to(torch.bfloat16), 1)


def test_fake_shapes():
    """The shape rules: outputs' shapes and dtypes, no launch counted."""
    runtime.reset_counts()
    with FakeTensorMode():
        x = torch.empty((3, 5, 8, 14, 14))
        w = torch.empty((3, 3, 3, 8, 16))
        b = torch.empty((3, 16))
        y = ops.WORKER_CONV(x, w, b, False)
        ys = ops.WORKER_CONV(x[:1], w, b, True)
        dx = ops.WORKER_CONV_DGRAD(y, w)
        dw, db = ops.WORKER_CONV_WGRAD(x, y, False)
        dws, dbs = ops.WORKER_CONV_WGRAD(x[:1], y, True)
        with pytest.raises(ValueError, match="f32"):
            ops.WORKER_CONV(x.to(torch.bfloat16), w.to(torch.bfloat16),
                            b.to(torch.bfloat16), False)
    assert tuple(y.shape) == tuple(ys.shape) == (3, 5, 16, 14, 14)
    assert tuple(dx.shape) == (3, 5, 8, 14, 14)
    assert tuple(dw.shape) == tuple(dws.shape) == (3, 3, 3, 8, 16)
    assert tuple(db.shape) == tuple(dbs.shape) == (3, 16)
    assert {t.dtype for t in (y, dx, dw, db)} == {torch.float32}
    assert runtime.counts() == {}


def test_op_cost_hand_count():
    """op_cost against a hand count at C 2, N 3, conv2's shape (8 -> 16
    channels, 14 x 14)."""
    x = torch.empty((2, 3, 8, 14, 14))
    w = torch.empty((2, 3, 3, 8, 16))
    b = torch.empty((2, 16))
    y = torch.empty((2, 3, 16, 14, 14))
    # y: 2*3*16*196 = 18,816 values, each 72 products and 72 sums and
    # the bias: 145 operations; x 9,408, w 2,304, b 32, y 18,816 floats
    assert runtime.op_cost(ops.WORKER_CONV, x, w, b, False) == (
        2_728_320, 4 * (9_408 + 2_304 + 32 + 18_816))
    # shared: one set of 3 images read once (4,704 floats)
    assert runtime.op_cost(ops.WORKER_CONV, x[:1], w, b, True) == (
        2_728_320, 4 * (4_704 + 2_304 + 32 + 18_816))
    # dx: 9,408 values, each 16 x 9 products and sums (288)
    assert runtime.op_cost(ops.WORKER_CONV_DGRAD, y, w) == (
        2_709_504, 4 * (18_816 + 2_304 + 9_408))
    # dw: each of gy's 18,816 values meets 72 inputs (144 operations)
    # and the bias (1); dw 2,304 and db 32 floats written
    assert runtime.op_cost(ops.WORKER_CONV_WGRAD, x, y, False) == (
        2_728_320, 4 * (9_408 + 18_816 + 2_304 + 32))


# ResNet at width x32 on 32 x 32 images: the stem, stage 0's 3x3
# convolutions and stage 1's stride-1 ones
RESNET_W32 = [(3, 32, 32), (32, 32, 32), (64, 64, 16)]


@pytest.mark.parametrize("cin,cout,hw", list(LAYERS.values()) + RESNET_W32)
def test_takes_asks_the_plans(monkeypatch, cin, cout, hw):
    """On the card `takes` asks `fits` of the weight's channels and the
    images' height and width (the leading dims, images and any worker
    dim vmap hides, do not enter)."""
    asked = []
    monkeypatch.setattr(ops, "on_card", lambda x: True)
    monkeypatch.setattr(ops, "fits",
                        lambda *shape: asked.append(shape) or False)
    x = torch.zeros((3, cin, hw, hw))
    assert not ops.takes(x, torch.zeros((3, 3, cin, cout)), 1)
    assert not ops.takes(x, torch.zeros((3, 3, cin, cout)), 2)
    assert asked == [(cin, cout, hw, hw)]


def test_cpu_wrappers_raise_on_cuda_paths():
    """The CUDA implementations refuse CPU tensors; no fallback."""
    x = torch.zeros((1, 2, 1, 5, 5))
    w = torch.zeros((1, 3, 3, 1, 8))
    with pytest.raises(ValueError, match="no kernel"):
        ops._conv_cuda(x, w, torch.zeros((1, 8)), False)
    with pytest.raises(ValueError, match="no kernel"):
        ops._wgrad_cuda(x, torch.zeros((1, 2, 8, 5, 5)), False)


# ---------------------------------------------------------------- card


def _f64_bound(fn, *args):
    """A plain version on the CPU in f64: (its value, the same sums over
    |terms|)."""
    args = [a.cpu().double() for a in args]
    return fn(*args), fn(*[a.abs() for a in args])


def _within(got, ref64, abs64, chain):
    """|got - exact| <= chain x 2^-24 x sum|terms| (recursive f32 sums of
    `chain` terms in any order, Higham's gamma_n), plus the result's own
    rounding."""
    tol = (chain + 1) * 2.0 ** -24 * abs64
    err = (got.cpu().double() - ref64).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


def _check_against_f64(dev, C, N, cin, cout, hw, shared, pick):
    """The three kernels at C workers against the plain versions in f64
    (workers `pick`), within the bound of f32 sums of each kernel's
    chains: 9 Cin terms (forward), 9 Cout (input gradient), a pixel
    group's pixels and then the groups (weight gradient)."""
    gen = torch.Generator(device=dev).manual_seed(N + cin)
    x = torch.randn((1 if shared else C, N, cin, hw, hw), device=dev,
                    generator=gen)
    w = torch.randn((C, 3, 3, cin, cout), device=dev, generator=gen)
    b = torch.randn((C, cout), device=dev, generator=gen)
    gy = torch.randn((C, N, cout, hw, hw), device=dev, generator=gen)
    y = ops.conv_raw(x, w, b, shared)
    dx = ops.dgrad_raw(gy, w)
    dw, db = ops.wgrad_raw(x, gy, shared)
    torch.cuda.synchronize()
    xs = x if shared else x[pick]
    ref, ab = _f64_bound(lambda a, c, d: worker_conv_ref(a, c, d, shared),
                         xs, w[pick], b[pick])
    _within(y[pick], ref, ab, 9 * cin + 1)
    ref, ab = _f64_bound(worker_conv_dgrad_ref, gy[pick], w[pick])
    _within(dx[pick], ref, ab, 9 * cout)
    p = ops.plan(True, C, N, cin, cout, hw, hw)
    # a thread's pixels over every staged chunk, then the groups
    chain = -(-N // p.imgs) * -(-p.imgs * hw * hw // p.groups) + p.groups
    (rw, rb), (aw, abb) = _f64_bound(
        lambda a, g: worker_conv_wgrad_ref(a, g, shared), xs, gy[pick])
    _within(dw[pick], rw, aw, chain)
    _within(db[pick], rb, abb, chain)


@pytest.mark.card
@pytest.mark.parametrize("N", [64, 2048])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_card_kernel_matches_plain(card, N, layer):
    """CNN5's three layers at C 200, a training step's 64 images and the
    scoring's 2,048 (conv1's images shared, as the scoring on D_g reads
    them), against f64 for workers 0, 101 and 199."""
    cin, cout, hw = LAYERS[layer]
    _check_against_f64(card, 200, N, cin, cout, hw,
                       layer == "conv1" and N == 2048, [0, 101, 199])


@pytest.mark.card
@pytest.mark.parametrize("C,N,cin,cout,hw,shared", [
    (3, 5, 3, 10, 32, False),     # rows wider than a warp with their halo
    (2, 7, 5, 3, 9, True),        # channels short of a multiple of 8
    (1, 3, 16, 8, 14, False)])
def test_card_other_shapes(card, C, N, cin, cout, hw, shared):
    """The kernels off CNN5's shapes (ResNet's and CIFAR-like images take
    the same operators), against f64 for every worker."""
    _check_against_f64(card, C, N, cin, cout, hw, shared, list(range(C)))


SHAPES = [(200, n, cin, cout, hw) for n in (64, 2048)
          for cin, cout, hw in LAYERS.values()] + [
    (1, 2048, 1, 8, 28), (3, 5, 3, 10, 9), (2, 7, 16, 8, 14),
    (4, 1, 5, 3, 32), (2, 64, 8, 8, 28)] + [
    (3, 4, cin, cout, hw) for cin, cout, hw in RESNET_W32]


@pytest.mark.card
@pytest.mark.parametrize("C,N,K,M,hw", SHAPES)
def test_card_plans(card, C, N, K, M, hw):
    """The kernel's plans: the forward's and input gradient's cover every
    output pixel once within a block's limits; the weight gradient's
    give every pixel group a pixel of each full chunk where memory
    allows; all within 256 threads and 232,448 B of shared memory. Of
    ResNet's x32 layers stage 0's do not fit the weight gradient."""
    for k, m in ((K, M), (M, K)):
        p = ops.plan(False, C, N, k, m, hw, hw)
        assert p.threads % 32 == 0 and 32 <= p.threads <= 256
        assert p.threads * 4 >= p.imgs * hw * hw > (p.threads - 32) * 4
        assert p.smem <= 232_448 and 1 <= p.imgs <= N and p.groups == 0
        mp = -(-m // 8) * 8
        assert mp % p.ct == 0
        assert p.smem == 4 * (9 * k * mp + mp + p.imgs * k * (hw + 2) ** 2)
    p = ops.plan(True, C, N, K, M, hw, hw)
    assert (p is None) == (K == 32 and hw == 32)
    if p is None:
        assert not ops.fits(K, M, hw, hw)
        return
    assert p.threads == K * p.groups and 32 <= p.threads <= 256
    assert p.smem <= 232_448 and 1 <= p.imgs <= N and p.ct == 8
    per_img = 8 * (K * (((hw + 2) ** 2) | 1) + 8 * hw * hw)
    assert p.smem == max(p.imgs * per_img, 4 * p.threads * 8)
    assert p.imgs * hw * hw >= min(p.groups, N * hw * hw) or \
        (p.imgs + 1) * per_img > 232_448
    assert ops.fits(K, M, hw, hw)


@pytest.mark.card
@pytest.mark.parametrize("arch,width,taken", [
    ("cnn5", 2, 3), ("resnet", 2, 8), ("resnet", 32, 4)])
def test_card_model_grads_match_cpu(card, arch, width, taken):
    """vmap(grad) of the loss of CNN5 and of a ResNet at width x2 (2 and
    4 channels) and x32 (32 and 64) on 32 x 32 x 3 images, C 3: on the
    card through the kernel where its plans fit (at x32 the stem and
    stage 1's three 3x3 stride-1 convolutions; stage 0's 32 channels of
    32 x 32 do not fit its weight gradient and stay F.conv2d), on the
    CPU through F.conv2d, within 1e-4 of the largest gradient of each
    leaf."""
    make = cnn.make_cnn5 if arch == "cnn5" else cnn.make_resnet
    model = make(32, 32, 3, 10, width_mult=width, device="cpu")
    gen = torch.Generator().manual_seed(9)
    params = tree_map(lambda v: v + 0.01 * torch.randn((3,) + v.shape,
                                                       generator=gen),
                      model.init(gen))
    x = torch.randn((3, 4, 32, 32, 3), generator=gen)
    y = torch.randint(0, 10, (3, 4), generator=gen)

    def loss(p, xb, yb):
        return F.cross_entropy(model.apply(p, xb), yb)

    grad = torch.func.vmap(torch.func.grad(loss))
    want = grad(params, x, y)
    runtime.reset_counts()
    with runner._deterministic_f32():       # TF32 off for ResNet's others
        got = grad(tree_map(lambda v: v.to(card), params), x.to(card),
                   y.to(card))
    assert runtime.counts()["worker_conv"] == taken
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        tol = 1e-4 * float(w.abs().max()) + 1e-7
        assert float((g.cpu() - w).abs().max()) <= tol


@pytest.mark.card
def test_card_two_calls_bitwise(card):
    """No float atomics: two calls of each kernel give the same bits."""
    gen = torch.Generator(device=card).manual_seed(1)
    for cin, cout, hw in LAYERS.values():
        x = torch.randn((200, 64, cin, hw, hw), device=card, generator=gen)
        w = torch.randn((200, 3, 3, cin, cout), device=card, generator=gen)
        b = torch.randn((200, cout), device=card, generator=gen)
        gy = torch.randn((200, 64, cout, hw, hw), device=card, generator=gen)
        for fn, args in ((ops.conv_raw, (x, w, b)), (ops.dgrad_raw, (gy, w)),
                         (ops.wgrad_raw, (x, gy))):
            a, c = fn(*args), fn(*args)
            for u, v in zip(a if isinstance(a, tuple) else (a,),
                            c if isinstance(c, tuple) else (c,)):
                assert torch.equal(u, v)


@pytest.mark.card
def test_card_launches_per_round(card):
    """One paper round at C 4, 2 steps: 3 forwards, 2 input gradients and
    3 weight gradients a step, 3 forwards for each of the two scoring
    passes at C 4, and the global loss's 3 forwards at C 1."""
    from repro_torch.experiments import get_scenario, override
    spec = override(get_scenario("low-bandwidth-int4"),
                    "data.num_workers=4", "data.n_local=128",
                    "algo.local_epochs=1", "algo.batch_size=64")
    prep = runner.build(spec, card)
    with runner._deterministic_f32():
        state = prep.state
        draws = prep.draw(state)
        runtime.reset_counts()
        prep.step(state, draws)
        torch.cuda.synchronize()
    by = runtime.counts_by_workers()
    assert by["worker_conv"] == {4: 2 * 3 + 2 * 3, 1: 3}
    assert by["worker_conv_dgrad"] == {4: 2 * 2}
    assert by["worker_conv_wgrad"] == {4: 2 * 3}
