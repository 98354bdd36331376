"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the cells run on the CPU at reduced
sizes with one fault planted in the port at a time. The faults a
one-card training cell can have: a step that returns its state
unchanged; half of each batch left out, the mean taken over the rest;
an answer altered where it is produced (the round's aggregate, the
global model's move, a quarter too long). (There is no exchange between
cards to leave out.) Besides, two decisions taken wrongly: every worker
selected whatever its score (Eq. 6; the paper cells, where some
worker's score passes the threshold in rounds 2-3), and no best ever
replaced (Eqs. 9)."""
import pytest
import torch

from bench.tests import tiny


def _wrap_build(monkeypatch, wrap):
    from repro_torch.experiments import runner
    build = runner.build

    def patched(*a, **kw):
        prep = build(*a, **kw)
        return prep._replace(step=wrap(prep.step))
    monkeypatch.setattr(runner, "build", patched)


def _unchanged(step):
    def broken(state, draws):
        _, info = step(state, draws)
        return state, info
    return broken


def _altered(monkeypatch, kind):
    """The aggregate 1.25 times what the wire delivered: on the packed
    route inside `receive_packed`, on the dense route in the decoded
    uplink that `receive` sums."""
    from repro_torch.comm import channel, compress
    from repro_torch.pytree import tree_map
    if kind == "paper":
        receive = channel.receive_packed

        def longer(comm, g, *a, **kw):
            out, mask = receive(comm, g, *a, **kw)
            return tree_map(lambda n, o: o + 1.25 * (n - o), out, g), mask
        monkeypatch.setattr(channel, "receive_packed", longer)
    else:
        cw = compress.compress_with_ef

        def longer(cfg, delta, residual, seeds):
            wire, res = cw(cfg, delta, residual, seeds)
            return tree_map(lambda x: 1.25 * x, wire), res
        monkeypatch.setattr(compress, "compress_with_ef", longer)


def _half_batch(monkeypatch, kind):
    if kind == "paper":
        from repro_torch.core import losses
        ce = losses.cross_entropy_loss

        def half(logits, labels, num_classes):
            n = logits.shape[0] // 2
            return ce(logits[:n], labels[:n], num_classes)
        monkeypatch.setattr(losses, "cross_entropy_loss", half)
    else:
        from repro_torch.core import rounds
        acc = rounds.accumulated_grad

        def half(grad_fn, params, batch, microbatches):
            n = batch["tokens"].shape[0] // 2
            return acc(grad_fn, params, {k: v[:n] for k, v in batch.items()},
                       microbatches)
        monkeypatch.setattr(rounds, "accumulated_grad", half)


def _select_all(monkeypatch, kind):
    from repro_torch.core import selection
    pick = selection.select_workers

    def every(theta, sel_state):
        _, nxt = pick(theta, sel_state)
        return torch.ones_like(theta), nxt
    monkeypatch.setattr(selection, "select_workers", every)


def _best_kept(monkeypatch, kind):
    if kind == "paper":
        from repro_torch.core import pso
        monkeypatch.setattr(pso, "update_local_best",
                            lambda state, losses: state._replace(
                                prev_loss=losses))
    else:
        from repro_torch.core import rounds
        monkeypatch.setattr(rounds, "track_local_best",
                            lambda best_params, best_loss, *a, **kw: (
                                best_params, best_loss))


SIZES = {"paper": tiny.paper, "mesh": tiny.mesh}
PLANT = {"half_batch": _half_batch, "altered": _altered,
         "select_all": _select_all, "best_kept": _best_kept}


@pytest.mark.parametrize("kind,fault", [
    (k, f) for k in ("paper", "mesh")
    for f in ("unchanged", "half_batch", "altered", "best_kept")]
    + [("paper", "select_all")])
def test_fault_is_not_correct(monkeypatch, kind, fault):
    torch.manual_seed(0)
    if fault == "unchanged":
        _wrap_build(monkeypatch, _unchanged)
    else:
        PLANT[fault](monkeypatch, kind)
    out = tiny.run(SIZES[kind](), 11)
    assert not out["correct"], out["checks"]
    if fault in ("select_all", "best_kept"):
        assert out["checks"]["decision_flips"]["value"] > 0, out["checks"]
