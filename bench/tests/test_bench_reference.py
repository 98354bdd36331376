"""The plain references in bench/reference agree with repro_torch on the
CPU at reduced sizes, given the same inputs: the pieces one by one, and
whole runs of the cells (a C 4 CNN5 fleet with the int4 wire, a 2-layer
transformer at the port's smoke widths) with `correct` true."""
import pytest
import torch

from bench import generator, harness
from bench.reference import cnn5, transformer, wire
from bench.reference.tree import leaves, tmap
from bench.tests import tiny


@pytest.mark.parametrize("bits,shape", [(4, (3, 3, 3, 8, 16)),
                                        (4, (3, 25088)), (8, (1, 40000))])
def test_wire_quantizer_matches_port(bits, shape):
    from repro_torch.kernels.quant_pack import quant_dequant
    g = torch.Generator().manual_seed(bits)
    x = torch.randn(shape, generator=g)
    seeds = torch.randint(0, 2**31 - 1, (shape[0],), generator=g,
                          dtype=torch.int32)
    assert torch.equal(wire.quant_dequant(x, seeds, bits),
                       quant_dequant(x, seeds, bits=bits))


def test_cnn5_matches_port():
    from repro_torch.configs.paper_cnn import paper_cnn
    cfg = harness.load_json("configs", "cnn5-w8-mnist")
    size = tiny.paper()
    p = generator.cnn5_params(cfg, 3, "cpu")
    d = generator.fleet_data(size["cell"]["traffic"], cfg, 3, "cpu")
    model = paper_cnn(width_mult=cfg["width_mult"], device="cpu")
    want = torch.stack([model.apply(p, d["x"][c, :32]) for c in range(2)])
    stacked = tmap(lambda x: x.expand((2,) + tuple(x.shape)), p)
    got = cnn5.apply(stacked, d["x"][:2, :32])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_transformer_loss_matches_port():
    from repro_torch.bridge import transformer_params_from_numpy
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import Transformer
    from bench.engines.mesh import _numpy
    size = tiny.mesh()
    cfg = size["config"]
    arch = get_arch("smollm-360m").reduced()
    p = generator.transformer_params(cfg, 4, "cpu")
    ported = transformer_params_from_numpy(arch, tmap(_numpy, p), "cpu")
    gen = generator.stream(4, "draws", "cpu")
    x = generator.token_round(gen, size["cell"]["traffic"], cfg["vocab_size"], 11, "cpu")
    tok, lab = x["eval"]["tokens"], x["eval"]["labels"]
    want = Transformer(arch).loss(ported, x["eval"])
    got = transformer.loss(p, tok, lab, cfg)
    torch.testing.assert_close(got, want.float(), rtol=2e-3, atol=0)
    lossv, grads = transformer.loss_grads(p, tok, lab, cfg, rows=1)
    flat = [t.detach().requires_grad_() for t in leaves(ported)]
    from repro_torch.pytree import tree_flatten, tree_unflatten
    _, treedef = tree_flatten(ported)
    ref = torch.autograd.grad(Transformer(arch).loss(
        tree_unflatten(treedef, flat), x["eval"]), flat)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b.float(), rtol=0.05,
                                   atol=0.05 * float(b.float().abs().max()))


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_paper_cell_correct_on_cpu(seed):
    out = tiny.run(tiny.paper(), seed)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_mesh_cell_correct_on_cpu():
    out = tiny.run(tiny.mesh(), 6)
    assert out["correct"], out["checks"]


def test_same_seed_same_inputs():
    cfg = harness.load_json("configs", "cnn5-w8-mnist")
    mix = tiny.paper()["cell"]["traffic"]
    a = generator.fleet_data(mix, cfg, 2**40 + 1, "cpu")
    b = generator.fleet_data(mix, cfg, 2**40 + 1, "cpu")
    c = generator.fleet_data(mix, cfg, 2**40 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["x"], c["x"])


def _records():
    """Two sound rounds of three workers, tau 0.9, as decisions.py reads
    them (Eq. 9 on the round's new params)."""
    eta = torch.tensor([0.0, 0.5, 1.0])
    l1, l2 = torch.tensor([2.0, 2.2, 2.4]), torch.tensor([2.1, 1.9, 2.5])
    out, best, gbest = [], torch.full((3,), float("inf")), torch.tensor(
        float("inf"))
    mean = torch.tensor(float("inf"))
    for losses, gloss in ((l1, torch.tensor(2.3)), (l2, torch.tensor(2.35))):
        theta = 0.9 * losses + (1.0 - 0.9) * eta
        mask = (theta <= mean).to(torch.float32)
        best = torch.where(losses < best, losses, best)
        gbest = torch.where(gloss < gbest, gloss, gbest)
        mean = theta.mean()
        out.append({"losses": losses, "theta": theta, "mask": mask,
                    "mean": mean, "eta": eta, "pre": losses, "best": best,
                    "gloss": gloss, "gbest": gbest})
    return out, eta


@pytest.mark.parametrize("change,flips", [
    (None, 0),
    ((1, "mask", lambda m: torch.ones(3)), 1),     # every worker selected
    ((1, "best", lambda b: torch.tensor([2.0, 2.2, 2.4])), 1),  # a best kept
    ((0, "best", lambda b: torch.full((3,), float("inf"))), 5),  # none
    ((1, "gbest", lambda g: torch.tensor(2.35)), 1),  # a worse global best
    # an eta off the reference's, and the score it gives off Eq. 5
    ((0, "eta", lambda e: torch.tensor([0.0, 0.5, 0.9])), 2),
    # two scores off Eq. 5, and the threshold is no longer their mean
    ((1, "theta", lambda t: t + torch.tensor([0.01, 0.01, 0.0])), 3)])
def test_decision_check_counts_departures(change, flips):
    from bench.reference import decisions
    records, eta = _records()
    if change:
        r, key, alter = change
        records[r] = dict(records[r], **{key: alter(records[r][key])})
    n, where = decisions.flips(records, eta, 0.9)
    assert n == flips, where


def test_decision_fallback_is_the_single_best():
    from bench.reference import decisions
    theta = torch.tensor([2.0, 1.5, 1.5])
    assert decisions.select(theta, torch.tensor(1.0)).tolist() == [0, 1, 0]
    assert decisions.select(theta, torch.tensor(1.8)).tolist() == [0, 1, 1]
