"""The kernel build's cache key (``kernels/build.py: library_path``): a
library is reused only while its source, every ``csrc`` header it includes
and its flags are unchanged.  Runs on the CPU: it hashes files and builds
nothing.  Also the reading of a kept ``ptxas -v`` log."""
import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary copy of ``csrc`` that the build reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def _paths():
    return {name: build.library_path(name) for name in build.KERNELS}


def test_unchanged_tree_keeps_every_library_path(csrc):
    before = _paths()
    (csrc / "unrelated.txt").write_text("not a source")
    assert _paths() == before


def test_flash_attention_sources_include_the_shared_header(csrc):
    names = [p.name for p in build.sources("flash_attention")]
    assert names[0] == "flash_attention.cu" and "sm90.cuh" in names
    assert [p.name for p in build.sources("gossip_mix")] == ["gossip_mix.cu"]


def test_editing_a_shared_header_rebuilds_only_its_includers(csrc):
    before = _paths()
    with open(csrc / "sm90.cuh", "a") as f:
        f.write("\n// an edit\n")
    after = _paths()
    includers = {name for name in build.KERNELS
                 if "sm90.cuh" in [p.name for p in build.sources(name)]}
    assert {"flash_attention", "paged_attention", "ssd_scan"} <= includers
    for name in build.KERNELS:
        if name in includers:
            assert after[name] != before[name], name
        else:
            assert after[name] == before[name], name


def test_a_header_included_through_another_counts(csrc):
    with open(csrc / "sm90.cuh", "a") as f:
        f.write('\n#include "nested.cuh"\n')
    (csrc / "nested.cuh").write_text("// v1\n")
    first = build.library_path("flash_attention")
    assert "nested.cuh" in [p.name for p in build.sources("flash_attention")]
    (csrc / "nested.cuh").write_text("// v2\n")
    assert build.library_path("flash_attention") != first


def test_a_kernels_own_flags_change_only_its_path(csrc, monkeypatch):
    before = _paths()
    monkeypatch.setitem(build.EXTRA_FLAGS, "gossip_mix",
                        ("-I/usr/local/cutlass/include",))
    after = _paths()
    assert build.flags("gossip_mix")[-1] == "-I/usr/local/cutlass/include"
    assert after["gossip_mix"] != before["gossip_mix"]
    assert {n: p for n, p in after.items() if n != "gossip_mix"} == {
        n: p for n, p in before.items() if n != "gossip_mix"}


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function 'kern_a' for 'sm_90a'
ptxas info    : Function properties for kern_a
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function 'kern_b' for 'sm_90a'
ptxas info    : Function properties for kern_b
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 40 registers, 6144 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_spills_and_shared_memory(
        csrc, tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    log = build.library_path("gossip_mix").with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(PTXAS_LOG)
    assert build.ptxas_report("gossip_mix") == [
        {"function": "kern_a", "registers": 168, "spill_stores": 0,
         "spill_loads": 0, "smem_bytes": 0},
        {"function": "kern_b", "registers": 40, "spill_stores": 12,
         "spill_loads": 16, "smem_bytes": 6144}]
