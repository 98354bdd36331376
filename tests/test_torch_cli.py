"""The port's CLI, legacy spec builders, tables and compat shims against
the JAX package's.

  * `launch.train`: for each argv list, the port's `build_spec_from_args`
    / `build_sweep_specs` on its own parser's Namespace give specs whose
    `to_dict` equals the reference's on the reference parser's Namespace
    (exact); the wrong-kind, bad-axis and stray-flag errors carry the
    reference's message (exact).
  * `spec_from_paper_kwargs` / `spec_from_mesh_kwargs`: `to_dict` equal
    (exact); `CASES` and `SPECS` have the reference's keys.
  * `channel.erasure_mask` on the reference's own keep draw and
    `synthetic.sample_dataset`: bitwise.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from repro.comm import channel as jchannel
from repro.comm.budget import CommConfig as JCommConfig
from repro.data import synthetic as jsynthetic
from repro.experiments import runner as jrunner
from repro.experiments import to_dict as jto_dict
from repro.launch import train as jtrain
from repro_torch.comm import channel as pchannel
from repro_torch.comm.budget import CommConfig as PCommConfig
from repro_torch.data import synthetic as psynthetic
from repro_torch.experiments import runner as prunner
from repro_torch.experiments import to_dict as pto_dict
from repro_torch.launch import train as ptrain

SPEC_ARGVS = [
    ["--scenario", "paper/fig3-noniid1", "--set", "run.rounds=2",
     "--set", "data.num_workers=8"],
    ["--mode", "paper", "--algorithm", "mdsl", "--case", "noniid2",
     "--dataset", "cifar_like", "--rounds", "40"],
    ["--mode", "paper", "--byzantine", "3", "--aggregator", "median",
     "--downlink-compressor", "int8"],
    ["--scenario", "low-bandwidth-int4", "--compressor", "topk",
     "--topk-ratio", "0.1", "--no-error-feedback", "--channel", "erasure",
     "--drop-prob", "0.2", "--byzantine-mode", "sign_flip",
     "--byzantine", "1", "--byzantine-scale", "5"],
    ["--mode", "paper", "--compressor", "int8", "--adaptive-bits",
     "--num-tiers", "3", "--tier-rank", "snr", "--fading", "rayleigh",
     "--doppler-rho", "0.8", "--snr-db", "12", "--channel", "awgn"],
    ["--scenario", "straggler/deadline-tight", "--round-deadline-s", "0.1",
     "--staleness-gamma", "1.0", "--quorum", "5", "--fault-prob", "0.1",
     "--fault-rounds", "2", "--fault-seed", "3", "--pathloss-spread-db",
     "3", "--outage-snr-db", "1.0", "--aggregator", "trimmed_mean",
     "--trim-ratio", "0.3"],
    ["--mode", "mesh", "--arch", "stablelm-3b", "--steps", "3",
     "--ckpt-dir", "ck", "--workers", "2", "--tau", "0.7"],
    ["--scenario", "mesh/smollm-smoke", "--steps", "2", "--set",
     "model.seq_len=16", "--obs", "--obs-dir", "obsdir", "--profile-dir",
     "prof"],
    ["--scenario", "quickstart", "--seed", "3", "--tau", "0.5", "--out",
     "out.json", "--model", "resnet", "--width-mult", "4", "--workers",
     "6", "--dataset", "cifar_like", "--case", "iid"],
    ["--mode", "mesh"],
]
SWEEP_ARGVS = [
    ["--sweep", "paper/fig3-iid,paper/fig3-noniid1,paper/fig3-noniid2",
     "--sweep-axis", "algo.algorithm=fedavg,dsl,multi_dsl,mdsl",
     "--set", "run.rounds=3"],
    ["--sweep", "quickstart, low-bandwidth-int4", "--sweep-axis",
     "comm.compressor=int8,int4", "--sweep-axis", "run.seed=1,2", "--obs",
     "--seeds", "0,1", "--jobs", "2"],
]
VALUE_ERRORS = [
    ["--scenario", "mesh/smollm-smoke", "--rounds", "2"],
    ["--mode", "paper", "--steps", "3", "--arch", "smollm-360m"],
    ["--mode", "mesh", "--case", "iid", "--width-mult", "2"],
    ["--scenario", "quickstart", "--set", "comm.no_such=1"],
]
SWEEP_VALUE_ERRORS = [
    ["--sweep", "quickstart", "--sweep-axis", "algo.algorithm"],
    ["--sweep", " , "],
    ["--sweep", "no/such-scenario"],
]
STRAY = [
    ["--sweep", "quickstart", "--rounds", "2", "--adaptive-bits"],
    ["--sweep", "quickstart", "--compressor", "int8", "--steps", "2",
     "--no-error-feedback"],
]


class _Stop(Exception):
    pass


def _ref_namespace(argv, monkeypatch):
    """The Namespace the reference's own parser builds for argv (its
    `main` stopped where it hands the Namespace on)."""
    got = {}

    def grab(args):
        got["args"] = args
        raise _Stop

    monkeypatch.setattr(jtrain, "build_spec_from_args", grab)
    monkeypatch.setattr(jtrain, "build_sweep_specs", grab)
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    with pytest.raises(_Stop):
        jtrain.main()
    monkeypatch.undo()
    return got["args"]


def _port_namespace(argv):
    return ptrain.parser().parse_args(argv)


@pytest.mark.parametrize("argv", SPEC_ARGVS,
                         ids=[" ".join(a[:2]) + f" #{i}"
                              for i, a in enumerate(SPEC_ARGVS)])
def test_spec_from_args_matches_reference(argv, monkeypatch):
    want = jto_dict(jtrain.build_spec_from_args(
        _ref_namespace(argv, monkeypatch)))
    got = pto_dict(ptrain.build_spec_from_args(_port_namespace(argv)))
    assert got == want


@pytest.mark.parametrize("argv", SWEEP_ARGVS, ids=["fig3-grid", "two-axes"])
def test_sweep_specs_match_reference(argv, monkeypatch):
    want = [jto_dict(s) for s in jtrain.build_sweep_specs(
        _ref_namespace(argv, monkeypatch))]
    got = [pto_dict(s) for s in ptrain.build_sweep_specs(
        _port_namespace(argv))]
    assert len(got) == len(want) and got == want


@pytest.mark.parametrize("argv", VALUE_ERRORS)
def test_spec_errors_match_reference(argv, monkeypatch):
    with pytest.raises(ValueError) as want:
        jtrain.build_spec_from_args(_ref_namespace(argv, monkeypatch))
    with pytest.raises(ValueError) as got:
        ptrain.build_spec_from_args(_port_namespace(argv))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv", SWEEP_VALUE_ERRORS)
def test_sweep_errors_match_reference(argv, monkeypatch):
    with pytest.raises(ValueError) as want:
        jtrain.build_sweep_specs(_ref_namespace(argv, monkeypatch))
    with pytest.raises(ValueError) as got:
        ptrain.build_sweep_specs(_port_namespace(argv))
    assert str(got.value) == str(want.value)


def _error_line(text):
    return [ln for ln in text.splitlines() if "error:" in ln][0].split(
        "error:", 1)[1]


@pytest.mark.parametrize("argv", STRAY)
def test_stray_sweep_flags_fail_as_in_reference(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    with pytest.raises(SystemExit):
        jtrain.main()
    want = _error_line(capsys.readouterr().err)
    with pytest.raises(SystemExit):
        ptrain.main(argv)
    assert _error_line(capsys.readouterr().err) == want
    assert "does not combine with --sweep" in want


def test_bare_cli_asks_for_a_spec(capsys):
    """The port's one departure: no --scenario, --mode or --sweep is an
    error, not a full-size default paper run."""
    with pytest.raises(SystemExit):
        ptrain.main(["--rounds", "1"])
    assert "--scenario, --mode or --sweep" in capsys.readouterr().err


@pytest.mark.parametrize("kwargs", [
    {},
    {"algorithm": "dsl", "case": "iid", "dataset": "cifar_like",
     "rounds": 3, "num_workers": 6, "model": "resnet", "width_mult": 2,
     "tau": 0.5, "local_epochs": 2, "batch_size": 32, "lr": 0.05,
     "velocity_clip": 0.0, "seed": 4, "eta_coeffs": (0.1, 0.2, 0.3),
     "n_local": 128, "log_every": 2},
], ids=["defaults", "every-kwarg"])
def test_spec_from_paper_kwargs_matches_reference(kwargs):
    jcomm = JCommConfig(compressor="int8", downlink_compressor="int4")
    pcomm = PCommConfig(compressor="int8", downlink_compressor="int4")
    assert (pto_dict(prunner.spec_from_paper_kwargs(**kwargs))
            == jto_dict(jrunner.spec_from_paper_kwargs(**kwargs)))
    assert (pto_dict(prunner.spec_from_paper_kwargs(comm=pcomm, **kwargs))
            == jto_dict(jrunner.spec_from_paper_kwargs(comm=jcomm, **kwargs)))


@pytest.mark.parametrize("kwargs", [
    {"arch": "smollm-360m"},
    {"arch": "stablelm-3b", "steps": 3, "reduced": False, "seq_len": 64,
     "per_worker_batch": 1, "num_spatial": 4, "ckpt_dir": "ck", "seed": 2},
], ids=["defaults", "every-kwarg"])
def test_spec_from_mesh_kwargs_matches_reference(kwargs):
    assert (pto_dict(prunner.spec_from_mesh_kwargs(**kwargs))
            == jto_dict(jrunner.spec_from_mesh_kwargs(**kwargs)))
    assert (pto_dict(prunner.spec_from_mesh_kwargs(
        comm=PCommConfig(channel="awgn"), **kwargs))
        == jto_dict(jrunner.spec_from_mesh_kwargs(
            comm=JCommConfig(channel="awgn"), **kwargs)))


def test_tables_and_exports_match_reference():
    assert set(prunner.CASES) == set(jrunner.CASES)
    assert ptrain.CASES is prunner.CASES
    assert set(ptrain.SPECS) == set(jtrain.SPECS)
    assert set(ptrain.__all__) == set(jtrain.__all__)
    assert set(jrunner.__all__) <= set(prunner.__all__)
    assert ptrain._noniid2_groups(50) == jtrain._noniid2_groups(50)
    spec = psynthetic.MNIST_LIKE
    for case, fn in prunner.CASES.items():
        data = fn(0, 6, spec, 16, device="cpu")
        assert tuple(data.x.shape) == (6, 16, 28, 28, 1), case
        assert tuple(data.y.shape) == (6, 16), case
    mixed = prunner.CASES["noniid2"](0, 10, spec, 16, device="cpu")
    assert mixed.alphas.tolist() == pytest.approx(
        [a for c, a in jtrain._noniid2_groups(10) for _ in range(c)])


@pytest.mark.parametrize("channel,outage", [
    ("erasure", None), ("composite", 0.0), ("ideal", 3.0), ("awgn", None)])
def test_erasure_mask_bitwise(channel, outage):
    """The reference draws its keep mask from the key; the port takes
    that draw as an input (the same bernoulli, from numpy)."""
    cfg_kw = dict(channel=channel, drop_prob=0.4, snr_db=10.0,
                  outage_snr_db=outage, fading="rayleigh")
    jcfg, pcfg = JCommConfig(**cfg_kw), PCommConfig(**cfg_kw)
    rng = np.random.default_rng(0)
    mask = (rng.random(12) < 0.7).astype(np.float32)
    snr = rng.normal(2.0, 4.0, 12).astype(np.float32)
    key = jax.random.PRNGKey(5)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - 0.4, (12,)),
                      np.float32)
    for s in (None, snr):
        want = np.asarray(jchannel.erasure_mask(
            jcfg, jax.numpy.asarray(mask), key,
            None if s is None else jax.numpy.asarray(s)))
        got = pchannel.erasure_mask(
            pcfg, torch.as_tensor(mask), torch.as_tensor(keep),
            None if s is None else torch.as_tensor(s)).numpy()
        np.testing.assert_array_equal(got, want)


def test_sample_dataset_is_sample_images_bitwise():
    """Each package's shim is its own `sample_images` plus the labels,
    bit for bit (their draws differ by design: the port takes a
    torch.Generator, the reference a key)."""
    spec = psynthetic.MNIST_LIKE
    labels = torch.as_tensor(np.random.default_rng(1).integers(0, 10, 32))
    gen = torch.Generator().manual_seed(3)
    protos = psynthetic.make_class_prototypes(gen, spec, "cpu")
    x, y = psynthetic.sample_dataset(torch.Generator().manual_seed(4),
                                     labels, protos, spec)
    want = psynthetic.sample_images(torch.Generator().manual_seed(4), labels,
                                    protos, spec)
    assert torch.equal(x, want) and y is labels
    key = jax.random.PRNGKey(4)
    jl = jax.numpy.asarray(labels.numpy())
    jp = jax.numpy.asarray(protos.numpy())
    jx, jy = jsynthetic.sample_dataset(key, jl, jp, jsynthetic.MNIST_LIKE)
    np.testing.assert_array_equal(
        np.asarray(jx), np.asarray(jsynthetic.sample_images(
            key, jl, jp, jsynthetic.MNIST_LIKE)))
    np.testing.assert_array_equal(np.asarray(jy), labels.numpy())
    assert tuple(x.shape) == tuple(jx.shape) == (32, 28, 28, 1)
