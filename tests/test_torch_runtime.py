"""The kernel runtime's build cache: a library is named by a hash of its
source, of every shared header in csrc/ and of the nvcc flags, so a
changed header (csrc/flash_wgmma.cuh, included by both flash sources)
builds anew instead of loading a stale library."""
from repro_torch.kernels import runtime


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "shared.cuh"\nint f();\n')
    (csrc / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(runtime, "CSRC", csrc)
    return csrc


def test_target_changes_with_a_header(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = runtime._target("kern")
    assert runtime._target("kern") == before          # stable
    (csrc / "shared.cuh").write_text("#pragma once\nint g();\n")
    after = runtime._target("kern")
    assert after != before
    assert after.parent == runtime.BUILD_DIR
    assert after.name.startswith("kern-") and after.suffix == ".so"


def test_target_changes_with_a_new_header_and_the_source(tmp_path,
                                                         monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    first = runtime._target("kern")
    (csrc / "other.cuh").write_text("#pragma once\n")
    second = runtime._target("kern")
    (csrc / "kern.cu").write_text('#include "shared.cuh"\nint f2();\n')
    third = runtime._target("kern")
    assert len({first, second, third}) == 3


def test_target_changes_with_the_flags(tmp_path, monkeypatch):
    _csrc(tmp_path, monkeypatch)
    before = runtime._target("kern")
    monkeypatch.setattr(runtime, "NVCC_FLAGS", runtime.NVCC_FLAGS + ("-G",))
    assert runtime._target("kern") != before


def test_counts_by_workers_tells_launch_shapes_apart():
    """A wire kernel's launches are counted by name and, apart, by the
    worker count they ran at; reset_counts clears both."""
    runtime.reset_counts()
    try:
        for c in (50, 1, 50):
            runtime.note_launch("quant_pack", workers=c)
        runtime.note_launch("pso_update")
        assert runtime.counts() == {"quant_pack": 3, "pso_update": 1}
        assert runtime.counts_by_workers() == {"quant_pack": {1: 1, 50: 2}}
    finally:
        runtime.reset_counts()
    assert runtime.counts() == {} and runtime.counts_by_workers() == {}
