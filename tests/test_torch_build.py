"""The port's kernel build plumbing on a host without nvcc: how
``utils/cuda.py`` plans the nvcc jobs of a source built in parts, runs jobs
and reports them, reuses a cached library, and counts launches. The real
builds run only on a CUDA host (tests/test_torch_cuda.py, chip_smoke.py)."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from qchem_rs_tpu_torch.ops import eri_kernel
from qchem_rs_tpu_torch.utils import cuda


def test_run_reports_each_job_under_its_label():
    report = cuda._run([
        (["echo", "first"], "a.cu"),
        ([sys.executable, "-c", "import sys; sys.stderr.write('second')"], "b.cu part 1"),
    ])
    lines = report.splitlines()
    assert lines[0].startswith("# nvcc a.cu: ") and lines[0].endswith(" s")
    assert lines[1] == "first"
    assert lines[2].startswith("# nvcc b.cu part 1: ") and lines[3] == "second"


def test_run_raises_with_every_failure():
    with pytest.raises(RuntimeError) as err:
        cuda._run([
            (["false"], "x.cu"),
            (["true"], "y.cu"),
            ([sys.executable, "-c", "import sys; sys.exit('boom')"], "z.cu"),
        ])
    msg = str(err.value)
    assert "nvcc failed on x.cu (exit 1)" in msg and "nvcc failed on z.cu (exit 1)" in msg
    assert "boom" in msg and "y.cu" not in msg


@pytest.mark.parametrize("parts", [1, 4, eri_kernel.BUILD_PARTS])
def test_build_plans_one_nvcc_job_per_part(tmp_path, monkeypatch, parts):
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    b = cuda._Build("eri_tile.cu", parts)
    assert not b.cached and b.lib.parent == tmp_path and b.lib.name.startswith("eri_tile-")
    assert len(b.jobs) == parts
    if parts == 1:
        assert "-shared" in b.jobs[0][0] and b.objs == []
    else:
        assert [cmd.count(f"-DKERNEL_PART={k}") for k, (cmd, _) in enumerate(b.jobs)] == [1] * parts
        assert all("-c" in cmd and "-shared" not in cmd for cmd, _ in b.jobs)
        assert len(set(b.objs)) == parts
    # the library is keyed by the source and its flags: another part count
    # builds another library
    assert cuda._Build("eri_tile.cu", parts + 1).lib != b.lib


def test_build_key_follows_the_shared_headers(tmp_path, monkeypatch):
    # both parts of kernel 1 include csrc/boys.cuh: editing it must rebuild
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "common.cuh"\n')
    (src / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda, "CSRC", src)
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    first = cuda._Build("k.cu", 1).lib
    assert cuda._Build("k.cu", 1).lib == first
    (src / "common.cuh").write_text("// two\n")
    assert cuda._Build("k.cu", 1).lib != first


def test_cached_build_runs_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    first = cuda._Build("fock_matvec.cu", 1)
    first.lib.write_bytes(b"")
    first.log.write_text("# nvcc fock_matvec.cu: 1.0 s\nptxas info\n")
    again = cuda._Build("fock_matvec.cu", 1)
    assert again.cached and again.jobs == []
    assert cuda._build_all([again]) == [(again.lib, "# nvcc fock_matvec.cu: 1.0 s\nptxas info\n")]


def test_report_of_keeps_each_sources_lines():
    report = (
        "# nvcc a.cu part 0: 1.0 s\nregs a0\n"
        "# nvcc b.cu: 2.0 s\nregs b\n"
        "# nvcc a.cu part 1: 1.5 s\nregs a1\n"
    )
    a, b = SimpleNamespace(src=Path("a.cu")), SimpleNamespace(src=Path("b.cu"))
    assert cuda._report_of(report, a) == (
        "# nvcc a.cu part 0: 1.0 s\nregs a0\n# nvcc a.cu part 1: 1.5 s\nregs a1\n")
    assert cuda._report_of(report, b) == "# nvcc b.cu: 2.0 s\nregs b\n"


def test_launch_counts_only_accepted_launches():
    k = cuda.CudaKernel("x.cu", "x_launch", [])
    k._fn = lambda *args: 0  # a launcher whose launch the runtime accepted
    k.launch(1, 2)
    k.launch(3)
    assert k.launches == 2
    k._fn = lambda *args: 700  # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="x_launch: CUDA launch failed with cudaError_t 700"):
        k.launch(4)
    assert k.launches == 2
