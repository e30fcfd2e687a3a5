"""The port's kernel build on the CPU, with a stand-in for nvcc.

The real build runs only where the CUDA toolkit is (chip_smoke.py's build
phase); here a fake ``nvcc`` on PATH checks the command lines (one compile
per source, then a link), the content-hashed library names, the cache and
the error paths.
"""
import stat

import pytest

from incubator_mxnet_tpu_torch import cuda_build
from incubator_mxnet_tpu_torch.base import MXNetError

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
if {fail!r}:
    print("error: fake compile failure")
    sys.exit(2)
assert args[:2] == ["-gencode", "arch=compute_90a,code=sm_90a"], args
out = args[args.index("-o") + 1]
open(out, "wb").write(b"not a real library")
open({calls!r}, "a").write(" ".join(a for a in args if a.endswith(".cu"))
                          + "\\n")
print("ptxas info    : Used 42 registers, used 1 barriers")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    import sys

    def install(fail=False):
        bindir = tmp_path / "bin"
        bindir.mkdir(exist_ok=True)
        nvcc = bindir / "nvcc"
        calls = tmp_path / "calls.txt"
        nvcc.write_text(FAKE_NVCC.format(python=sys.executable, fail=fail,
                                         calls=str(calls)))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("PATH", str(bindir), prepend=":")
        return calls

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    return install


def test_build_all_compiles_each_source_once(fake_nvcc):
    calls = fake_nvcc()
    built = cuda_build.build_all()
    assert sorted(built) == sorted(cuda_build.KERNELS)
    lib = cuda_build.lib_path("flash_attention")
    assert lib.parent == cuda_build.BUILD_DIR and lib.exists()
    assert "Used 42 registers" in cuda_build.build_log("flash_attention")
    assert cuda_build.build_all() == {}                  # cached by content
    sources = calls.read_text().split()
    assert sorted(s.rsplit("/", 1)[-1] for s in sources) == sorted(
        cuda_build.SOURCES["flash_attention"])    # one nvcc for each source
    assert cuda_build.SOURCES["flash_attention"] == (
        "flash_attention.cu", "flash_attention_sm90.cu",
        "flash_attention_f32_sm90.cu", "flash_attention_wide_sm90.cu",
        "flash_attention_bwd_sm90.cu")
    assert not list(cuda_build.BUILD_DIR.glob("*.tmp-*"))


def test_build_failure_raises_with_compiler_output(fake_nvcc):
    fake_nvcc(fail=True)
    with pytest.raises(MXNetError, match="fake compile failure"):
        cuda_build.build_all()
    assert not cuda_build.lib_path("flash_attention").exists()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(MXNetError, match="nvcc not found"):
        cuda_build.build_all()
    with pytest.raises(MXNetError, match="nvcc not found"):
        cuda_build.load("flash_attention")


def test_library_name_follows_source_and_flags(monkeypatch):
    a = cuda_build.lib_path("flash_attention")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    b = cuda_build.lib_path("flash_attention")
    assert a != b and a.name.startswith("libflash_attention-")


@pytest.mark.parametrize("source", ["flash_attention.cu",
                                    "flash_attention_sm90.cu",
                                    "flash_attention_f32_sm90.cu",
                                    "flash_attention_wide_sm90.cu",
                                    "flash_sm90_common.cuh"])
def test_library_name_follows_every_source(source, tmp_path, monkeypatch):
    headers = [p.name for p in cuda_build.CSRC.glob("*.cuh")]
    assert "flash_sm90_common.cuh" in headers
    for name in list(cuda_build.SOURCES["flash_attention"]) + headers:
        (tmp_path / name).write_bytes((cuda_build.CSRC / name).read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    a = cuda_build.lib_path("flash_attention")
    (tmp_path / source).write_text("// edited\n", encoding="utf-8")
    assert cuda_build.lib_path("flash_attention") != a


def test_backward_source_is_built_and_hashed(tmp_path, monkeypatch):
    """The backward kernel's source is one of the library's, its entry
    points are bound, and an edit to it renames (so rebuilds) the library."""
    import shutil
    assert "flash_attention_bwd_sm90.cu" in cuda_build.SOURCES[
        "flash_attention"]
    for entry in ("flash_attention_bwd_bf16", "flash_attention_bwd_f16"):
        restype, argtypes = cuda_build.KERNELS["flash_attention"][entry]
        assert len(argtypes) == 16
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    before = cuda_build.lib_path("flash_attention")
    src = csrc / "flash_attention_bwd_sm90.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build.lib_path("flash_attention") != before


@pytest.mark.parametrize("entry,n_args", [("flash_attention_wide_bf16", 11),
                                          ("flash_attention_wide_f16", 11),
                                          ("flash_attention_wide_f32", 10)])
def test_wide_entry_points_are_bound(entry, n_args):
    """Head dims above 256: routes A (bf16, f16: q, k, v, o, batch_heads,
    sq, sk, d, scale, causal, stream) and B (the planes, o, batch_heads, sq,
    sk, d, causal, stream) have C entry points in the library built from
    csrc/flash_attention_wide_sm90.cu, and the CUDA-core kernel's is gone."""
    import ctypes
    kernels = cuda_build.KERNELS["flash_attention"]
    assert "flash_attention_wide" not in kernels
    assert "flash_attention_wide_sm90.cu" in cuda_build.SOURCES[
        "flash_attention"]
    restype, argtypes = kernels[entry]
    assert restype is ctypes.c_int and len(argtypes) == n_args
    assert argtypes[-1] is ctypes.c_void_p        # the stream
    assert argtypes[:4] == [ctypes.c_void_p] * 4  # q, k, v, o
