"""``kernels/_build``: every missing library's compiler started at once
(``start_all``), each waited for on its own (``finish``), a build still
running ended (``stop_all``), on the CPU with a stand-in for ``nvcc``
(a script that writes its ``-o`` file after a delay, or fails)."""
import os
import stat
import sys
import time

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
src = os.path.basename(sys.argv[-1])
if src in os.environ.get("FAKE_NVCC_FAIL", "").split(","):
    print("error in " + src)
    sys.exit(2)
if src in os.environ.get("FAKE_NVCC_SLOW", "").split(","):
    time.sleep(float(os.environ["FAKE_NVCC_DELAY"]))
open(out, "wb").write(b"lib")
print("ptxas info    : Used 1 registers in " + src)
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    tool = tmp_path / "nvcc"
    tool.write_text(FAKE_NVCC.format(python=sys.executable))
    tool.chmod(tool.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "nvcc", lambda: str(tool))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setenv("FAKE_NVCC_DELAY", "30")
    yield tmp_path
    _build.stop_all()


def test_finish_waits_for_one_source_alone(fake_nvcc, monkeypatch):
    """A slow source still compiles while the others are waited for;
    each library and its log appear when its build is finished."""
    slow = "flash_attention_f32_bwd"
    monkeypatch.setenv("FAKE_NVCC_SLOW", f"{slow}.cu")
    monkeypatch.setenv("FAKE_NVCC_DELAY", "2")
    t0 = time.perf_counter()
    _build.start_all()
    secs = {n: _build.finish(n) for n in _build.SOURCES if n != slow}
    assert time.perf_counter() - t0 < 2
    assert all(_build.lib_path(n).exists() for n in secs)
    assert not _build.lib_path(slow).exists()
    assert _build.finish(slow) >= 2
    assert _build.lib_path(slow).read_bytes() == b"lib"
    assert "Used 1 registers" in _build.lib_path(slow).with_suffix(
        ".log").read_text()
    # built: nothing starts again, and finish has nothing to wait for
    _build.start_all()
    assert all(_build.finish(n) == 0.0 for n in _build.SOURCES)


def test_stop_all_ends_a_running_build(fake_nvcc, monkeypatch):
    """A build still running is killed: no library, no temporary file."""
    monkeypatch.setenv("FAKE_NVCC_SLOW", "rglru_scan.cu")
    _build.start_all()
    _build.stop_all()
    assert not _build.lib_path("rglru_scan").exists()
    assert not any(p.name.endswith(".tmp")
                   for p in (fake_nvcc / "build").iterdir())
    assert _build.finish("rglru_scan") == 0.0


def test_a_failed_build_raises_with_its_log(fake_nvcc, monkeypatch):
    """Waiting for a failed source raises with its compiler output and
    writes no library; the others build."""
    monkeypatch.setenv("FAKE_NVCC_FAIL", "decode_attention.cu")
    _build.start_all()
    with pytest.raises(RuntimeError, match="error in decode_attention.cu"):
        _build.finish("decode_attention")
    assert not _build.lib_path("decode_attention").exists()
    assert _build.finish("segment_trapz") > 0.0
    assert _build.lib_path("segment_trapz").exists()
    assert os.path.exists(_build.lib_path("decode_attention")
                          .with_suffix(".log"))
