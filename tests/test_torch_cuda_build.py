"""The kernel build cache of the port (``ops/cuda_build.py``), on the CPU.

No ``nvcc`` is needed: these tests point ``CSRC_DIR`` and ``BUILD_DIR`` at a
temporary directory and check how a library is named and how the
compiler's ``-Xptxas -v`` log is read.

- A library's path hashes its ``.cu`` source and every shared ``.cuh``
  header, so an edited header rebuilds every source, and an unchanged tree
  reuses what was built.
- ``parse_ptxas`` reads registers, spills, stack and static shared memory
  per kernel; ``kernel_resources`` reads the log kept beside the library.
"""

import pytest

from sharetrade_tpu_torch.ops import cuda_build

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi128EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 158 registers, used 1 barriers, 48 bytes smem, 796 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEvv
    24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 412 bytes cmem[0]
"""


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "shared.cuh"\n')
    (src / "b.cu").write_text("// another source\n")
    (src / "shared.cuh").write_text("// shared header v1\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    return src


def test_library_path_is_stable_while_nothing_changes(csrc):
    assert cuda_build._library_path("a") == cuda_build._library_path("a")
    assert cuda_build._library_path("a") != cuda_build._library_path("b")
    assert cuda_build.sources() == ["a", "b"]


@pytest.mark.parametrize("edited,rebuilds", [
    ("shared.cuh", ["a", "b"]),       # a header: every source rebuilds
    ("a.cu", ["a"]),                  # a source: only itself
    ("other.cuh", ["a", "b"]),        # a new header counts too
])
def test_library_path_follows_sources_and_headers(csrc, edited, rebuilds):
    before = {n: cuda_build._library_path(n) for n in ("a", "b")}
    (csrc / edited).write_text("// edited\n")
    after = {n: cuda_build._library_path(n) for n in ("a", "b")}
    assert sorted(n for n in before if before[n] != after[n]) == rebuilds


def test_parse_ptxas_reads_each_kernel():
    usage = cuda_build.parse_ptxas(PTXAS_LOG)
    assert usage == {
        "_Z6kernelILi128EEvv": {"stack": 0, "spill_stores": 0,
                                "spill_loads": 0, "registers": 158,
                                "static_smem": 48},
        "_Z6kernelILi64EEvv": {"stack": 24, "spill_stores": 16,
                               "spill_loads": 8, "registers": 255,
                               "static_smem": 0},
    }


def test_kernel_resources_reads_the_log_beside_the_library(csrc):
    assert cuda_build.kernel_resources("a") == {}
    lib = cuda_build._library_path("a")
    (csrc.parent / "_build").mkdir()
    with open(lib[:-3] + ".log", "w") as f:
        f.write(PTXAS_LOG)
    assert cuda_build.kernel_resources("a")["_Z6kernelILi128EEvv"][
        "registers"] == 158
    (csrc / "shared.cuh").write_text("// shared header v2\n")
    assert cuda_build.kernel_resources("a") == {}
