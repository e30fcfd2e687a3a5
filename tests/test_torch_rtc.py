"""Runtime-compiled CUDA kernels in the PyTorch port (``mx.rtc.CudaModule``
over NVRTC), the counterpart of the JAX build's runtime Pallas kernels
(``incubator_mxnet_tpu/rtc.py``).

The CPU cases cover the signature parser, the errors, and the paths that
need no card; the ``cuda`` cases compile and launch on the card and skip
without one:

    python -m pytest -m cuda tests/test_torch_rtc.py
"""
import ctypes
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import _cuda_driver, rtc
from incubator_mxnet_tpu_torch.base import MXNetError

# the JAX build's one user kernel (tests/test_rtc_resume.py:13-24), in CUDA C,
# and one kernel without extern "C"; NVRTC has no <cstdint>, so the source
# names its own int64_t
AXPY = r"""
typedef long long int64_t;
extern "C" __global__ void axpy(const float *x, const float *y, float *o,
                                int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) o[i] = 2.0f * x[i] + y[i];
}
__global__ void scale(double *x, double a, int64_t n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) x[i] *= a;
}
extern "C" __global__ void noop() {}
"""
AXPY_SIG = "const float *x, const float *y, float *o, int n"

ALL_TYPES = [
    ("float", "float32", ctypes.c_float),
    ("double", "float64", ctypes.c_double),
    ("__half", "float16", ctypes.c_uint16),
    ("uint8_t", "uint8", ctypes.c_uint8),
    ("int8_t", "int8", ctypes.c_int8),
    ("int32_t", "int32", ctypes.c_int32),
    ("int", "int32", ctypes.c_int32),
    ("int64_t", "int64", ctypes.c_int64),
]


@pytest.mark.parametrize("ctype,dtype,scalar", ALL_TYPES,
                         ids=[t[0] for t in ALL_TYPES])
def test_signature_types(ctype, dtype, scalar):
    params = rtc.parse_signature(
        "const %s *a, %s* b, %s c, const %s d" % ((ctype,) * 4))
    assert [(p.dtype, p.is_pointer, p.is_const, p.name) for p in params] == [
        (dtype, True, True, "a"), (dtype, True, False, "b"),
        (dtype, False, False, "c"), (dtype, False, True, "d")]
    assert rtc._TYPES[ctype][1] is scalar


def test_signature_spacing_and_empty():
    p = rtc.parse_signature("  const   float*x ,float *  y,int n ")
    assert [repr(q) for q in p] == ["const float *x", "float *y", "int n"]
    assert rtc.parse_signature("") == [] and rtc.parse_signature("void") == []


@pytest.mark.parametrize("sig", ["float **x", "unsigned int n", "long x",
                                 "const float *x, char *s", "float *x,",
                                 "struct S s", "float x[4]"])
def test_signature_errors(sig):
    with pytest.raises(MXNetError):
        rtc.parse_signature(sig)


def test_pallas_module_raises():
    with pytest.raises(MXNetError, match="CudaModule"):
        tmx.rtc.PallasModule({"axpy": lambda x, y, o: None})
    with pytest.raises(MXNetError, match="CudaModule"):
        tmx.rtc.PallasKernel("axpy", None)


def _nvrtc_present():
    try:
        _cuda_driver.nvrtc()
    except MXNetError:
        return False
    return True


def test_cuda_module_without_nvrtc_raises(monkeypatch, tmp_path):
    """With no NVRTC anywhere it looks, CudaModule raises MXNetError naming
    what is missing; where NVRTC is installed the search is pointed at an
    empty directory to show the same."""
    if _nvrtc_present():
        monkeypatch.setattr(_cuda_driver, "_LIBS", {})
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(_cuda_driver.site, "getsitepackages",
                            lambda: [str(tmp_path)])
        monkeypatch.setattr(_cuda_driver.ctypes.util, "find_library",
                            lambda name: None)
    with pytest.raises(MXNetError, match="NVRTC.*not found"):
        tmx.rtc.CudaModule(AXPY, exports=["axpy"])


@pytest.fixture
def fake_compiled(monkeypatch):
    """A module that 'compiled' without NVRTC: what a CPU test can reach
    of the launch path before the card."""
    calls = []

    def fake(source, options, names):
        calls.append(options)
        return b"cubin", {n: n for n in names}, ""

    monkeypatch.setattr(_cuda_driver, "compile_to_cubin", fake)
    return calls


def test_module_options_and_exports(fake_compiled):
    mod = tmx.rtc.CudaModule(AXPY, options=["-DFOO=1"],
                             exports=["axpy", "scale"])
    assert fake_compiled[0][0] == "--gpu-architecture=sm_90a"
    assert fake_compiled[0][-1] == "-DFOO=1"
    k = mod.get_kernel("axpy", AXPY_SIG)
    assert mod.get_kernel("axpy", " const float *x, const float *y, "
                          "float *o, int n") is k
    assert k.launches == 0
    with pytest.raises(MXNetError, match="not exported"):
        mod.get_kernel("nope", "int n")


def test_launch_on_cpu_context_raises(fake_compiled):
    mod = tmx.rtc.CudaModule(AXPY, exports=["axpy"])
    k = mod.get_kernel("axpy", AXPY_SIG)
    with tmx.cpu():
        x = tmx.nd.ones(8)
        o = tmx.nd.zeros(8)
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([x, x, o, 8], tmx.cpu(), grid_dims=(1,), block_dims=(8,))
    assert k.launches == 0


@pytest.fixture
def fake_card(monkeypatch):
    """gpu(0) resolved to the CPU device: a launch on it gets through its
    argument checks without a card, and would fail only at the driver."""
    monkeypatch.setattr(rtc.Context, "torch_device",
                        lambda self: torch.device("cpu"))


# ctypes would wrap each of these into the C type without a word
OUT_OF_RANGE = [("int", 2 ** 31), ("int", -2 ** 31 - 1),
                ("int32_t", 3_000_000_000), ("uint8_t", 300), ("uint8_t", -1),
                ("int8_t", 128), ("int64_t", 2 ** 63)]


@pytest.mark.parametrize("ctype,value", OUT_OF_RANGE,
                         ids=["%s=%d" % c for c in OUT_OF_RANGE])
def test_integer_scalar_out_of_range_raises(fake_compiled, fake_card, ctype,
                                            value):
    mod = tmx.rtc.CudaModule(AXPY, exports=["axpy"])
    k = mod.get_kernel("axpy", "const float *x, %s n" % ctype)
    with tmx.cpu():
        x = tmx.nd.ones(8)
    with pytest.raises(MXNetError, match=r"argument 1 \(%s n\).*out of range"
                       % ctype):
        k.launch([x, value], tmx.gpu(0), (1,), (8,))
    assert k.launches == 0


@pytest.mark.parametrize("ctype", ["int", "int32_t", "uint8_t", "int8_t",
                                   "int64_t"])
def test_integer_scalar_range_edges_pass(fake_compiled, ctype):
    k = tmx.rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel(
        "axpy", "%s n" % ctype)
    (param,) = k.params
    ((pack, ctype),) = k._packers
    info = np.iinfo(param.dtype)
    for v in (info.min, info.max, np.int64(0)):
        holder = ctype()
        pack(v, holder, (-1, torch.device("cpu")))
        assert holder.value == v


# -- the launch path against a recording fake of the driver -------------------

class FakeDriver:
    """libcuda as ctypes ``CFUNCTYPE`` stand-ins with the real restypes and
    argtypes (``_cuda_driver._DRIVER_FUNCS``), so the compiled launcher
    calls them through C as it calls the driver.  Each call is recorded as
    ``(name, thread id, details)``; the current context is kept per thread;
    ``cuLaunchKernel`` copies out the values its parameter pointers point
    at (``sizes`` bytes each) when it is called, after waiting at
    ``barrier`` if one is set, and returns ``launch_result``."""

    CTX0 = 0x1000       # primary context of device i: CTX0 + i

    def __init__(self):
        self.calls = []
        self.sizes = []
        self.stream = 0x5000
        self.barrier = None
        self.launch_result = 0
        self.device = torch.device("cpu")   # what gpu(i) resolves to
        self._current = threading.local()
        self._error = b"CUDA_ERROR_FAKE"
        for name, (restype, argtypes) in _cuda_driver._DRIVER_FUNCS.items():
            setattr(self, name, ctypes.CFUNCTYPE(restype, *argtypes)(
                getattr(self, "_" + name)))

    def _record(self, name, *details):
        self.calls.append((name, threading.get_ident()) + details)
        return 0

    def named(self, name):
        return [c for c in self.calls if c[0] == name]

    def _cuInit(self, flags):
        return 0

    def _cuGetErrorString(self, result, out):
        out[0] = self._error
        return 0

    def _cuDeviceGet(self, out, ordinal):
        out[0] = ordinal
        return 0

    def _cuDevicePrimaryCtxRetain(self, out, dev):
        out[0] = self.CTX0 + dev
        return 0

    def _cuCtxSetCurrent(self, ctx):
        self._current.ctx = ctx
        return self._record("cuCtxSetCurrent", ctx)

    def _cuCtxGetCurrent(self, out):
        out[0] = getattr(self._current, "ctx", None)
        return 0

    def _cuModuleLoadData(self, out, image):
        out[0] = 0x2000
        return 0

    def _cuModuleGetFunction(self, out, module, name):
        out[0] = 0x3000
        return self._record("cuModuleGetFunction", name)

    def _cuFuncSetAttribute(self, func, attribute, value):
        return self._record("cuFuncSetAttribute", attribute, value)

    def _cuLaunchKernel(self, func, gx, gy, gz, bx, by, bz, shared, stream,
                        params, extra):
        if self.barrier is not None:
            self.barrier.wait(timeout=10)
        values = [ctypes.string_at(params[i], n)
                  for i, n in enumerate(self.sizes)] if params else None
        self._record("cuLaunchKernel", func, (gx, gy, gz), (bx, by, bz),
                     shared, stream, values)
        return self.launch_result


@pytest.fixture
def fake_driver(monkeypatch, fake_compiled):
    """The launch path on the CPU: a recording fake driver, gpu(i) resolved
    to ``drv.device`` (the CPU, so CPU arrays pass the device check), and
    torch's raw-stream getter returning ``drv.stream``."""
    drv = FakeDriver()
    monkeypatch.setattr(_cuda_driver, "driver", lambda: drv)
    monkeypatch.setattr(_cuda_driver, "_PRIMARY", {})
    monkeypatch.setattr(rtc, "_raw_stream",
                        lambda: lambda index: drv.stream)
    monkeypatch.setattr(rtc.Context, "torch_device",
                        lambda self: drv.device)
    return drv


def _cpu(x, dtype="float32"):
    with tmx.cpu():
        return tmx.nd.array(np.asarray(x), dtype=dtype)


def _slot(ctype, value):
    return bytes(ctype(value))


# each scalar type at its values: integers at their range edges, floats at
# values their C type rounds, __half as its f16 bits
PACK_CASES = [(c, v) for c, _, _ in ALL_TYPES if c in (
    "uint8_t", "int8_t", "int32_t", "int", "int64_t")
    for v in (int(np.iinfo(rtc._Param(c, False, False, "n").dtype).min),
              int(np.iinfo(rtc._Param(c, False, False, "n").dtype).max),
              np.int64(7))] + [
    ("float", 0.1), ("float", -3), ("float", np.float32(1.5)),
    ("double", 0.1), ("double", 1e300), ("__half", 0.1), ("__half", 65504),
    ("__half", -2.5)]


@pytest.mark.parametrize("ctype,value", PACK_CASES,
                         ids=["%s=%r" % (c, v) for c, v in PACK_CASES])
def test_fake_launch_packs_exact_bytes(fake_driver, ctype, value):
    """Every parameter reaches cuLaunchKernel as the bytes of its C type:
    pointers as their tensor's data_ptr(), integers at their range edges,
    floats rounded to their C type, __half as its f16 bits."""
    dtype, scalar = rtc._TYPES[ctype]
    k = tmx.rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel(
        "axpy", "const %s *a, %s *b, %s c" % ((ctype,) * 3))
    a, b = _cpu([1, 2], dtype), _cpu([3, 4], dtype)
    fake_driver.sizes = [8, 8, ctypes.sizeof(scalar)]
    k.launch([a, b, value], tmx.gpu(0), (2,), (32,))
    if ctype == "__half":
        want = _slot(scalar, int(np.float16(value).view(np.uint16)))
    elif ctype in ("float", "double"):
        want = _slot(scalar, float(value))
    else:
        want = _slot(scalar, int(value))
    (launch,) = fake_driver.named("cuLaunchKernel")
    assert launch[-1] == [_slot(ctypes.c_uint64, a._data.data_ptr()),
                          _slot(ctypes.c_uint64, b._data.data_ptr()), want]
    assert k.launches == 1


def test_fake_launch_geometry_stream_and_versions(fake_driver):
    """The grid, block, shared bytes and the current stream reach the
    driver as given, read anew at every launch; only the mutable pointer's
    version counter moves."""
    k = tmx.rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel("axpy",
                                                               AXPY_SIG)
    x, y, o = _cpu([1.0]), _cpu([2.0]), _cpu([0.0])
    versions = [t._data._version for t in (x, y, o)]
    k.launch([x, y, o, 1], tmx.gpu(0), (3, 2), 64, shared_mem=1024)
    fake_driver.stream = 0x6000
    k.launch([x, y, o, 1], tmx.gpu(0), [5], (8, 4, 2))
    first, second = fake_driver.named("cuLaunchKernel")
    assert first[2:7] == (0x3000, (3, 2, 1), (64, 1, 1), 1024, 0x5000)
    assert second[2:7] == (0x3000, (5, 1, 1), (8, 4, 2), 0, 0x6000)
    assert [t._data._version - v for t, v in zip((x, y, o), versions)] == \
        [0, 0, 2]
    assert k.launches == 2


def test_fake_context_set_once_per_thread_and_device(fake_driver):
    """cuCtxSetCurrent runs once per thread and device: not again while the
    thread's current context is the device's, again on a new thread (which
    starts with none, as autograd's worker does) and after a launch on
    another device made that one current."""
    k = tmx.rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel("axpy",
                                                               "int n")
    ctx0, ctx1 = FakeDriver.CTX0, FakeDriver.CTX0 + 1
    me = threading.get_ident()
    for _ in range(3):
        k.launch([1], tmx.gpu(0), (1,), (1,))
    assert [c[1:] for c in fake_driver.named("cuCtxSetCurrent")] == \
        [(me, ctx0)]
    other = []
    thread = threading.Thread(target=lambda: [
        k.launch([1], tmx.gpu(0), (1,), (1,)) for _ in range(2)] and
        other.append(threading.get_ident()))
    thread.start()
    thread.join()
    k.launch([1], tmx.gpu(1), (1,), (1,))
    k.launch([1], tmx.gpu(0), (1,), (1,))
    k.launch([1], tmx.gpu(0), (1,), (1,))
    assert [c[1:] for c in fake_driver.named("cuCtxSetCurrent")] == [
        (me, ctx0), (other[0], ctx0), (me, ctx1), (me, ctx0)]
    assert k.launches == 8 and sorted(k._sites) == [0, 1]


def test_fake_shared_attribute_once_per_new_maximum(fake_driver):
    """cuFuncSetAttribute runs only for dynamic shared memory above 48 KB
    and above the largest already allowed on the device."""
    k = tmx.rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel("axpy",
                                                               "int n")
    for shared in (0, 48 * 1024, 64 * 1024, 64 * 1024, 32 * 1024,
                   100 * 1024, 80 * 1024):
        k.launch([1], tmx.gpu(0), (1,), (1,), shared)
    assert [c[2:] for c in fake_driver.named("cuFuncSetAttribute")] == [
        (_cuda_driver.CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED, 64 * 1024),
        (_cuda_driver.CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED, 100 * 1024)]
    assert [c[5] for c in fake_driver.named("cuLaunchKernel")] == [
        0, 49152, 65536, 65536, 32768, 102400, 81920]


def _bad_launches():
    """(name, launch of the axpy kernel that must raise, message)"""
    x = _cpu(np.ones(8))
    strided = tmx.nd.NDArray(torch.ones(4, 4).t())
    return [
        ("arity", lambda k: k.launch([x, x, x], tmx.gpu(0), (1,), (8,)),
         "takes 4 arguments"),
        ("dtype", lambda k: k.launch([x, _cpu(np.ones(8), "int32"), x, 8],
                                     tmx.gpu(0), (1,), (8,)),
         "must be float32, got int32"),
        ("contiguous", lambda k: k.launch([x, x, strided, 8], tmx.gpu(0),
                                          (1,), (8,)), "not contiguous"),
        ("not an NDArray", lambda k: k.launch([x, x._data, x, 8],
                                              tmx.gpu(0), (1,), (8,)),
         "must be an NDArray"),
        ("number", lambda k: k.launch([x, x, x, x], tmx.gpu(0), (1,), (8,)),
         "must be a number"),
        ("tensor scalar", lambda k: k.launch([x, x, x, torch.tensor(8)],
                                             tmx.gpu(0), (1,), (8,)),
         "must be a number"),
        ("integer", lambda k: k.launch([x, x, x, 2.5], tmx.gpu(0), (1,),
                                       (8,)), "must be an integer"),
        ("range", lambda k: k.launch([x, x, x, 2 ** 31], tmx.gpu(0), (1,),
                                     (8,)), "out of range for int"),
        ("threads", lambda k: k.launch([x, x, x, 8], tmx.gpu(0), (1,),
                                       (64, 32)), "more than 1024"),
        ("grid", lambda k: k.launch([x, x, x, 8], tmx.gpu(0), (0,), (8,)),
         "grid_dims"),
        ("grid rank", lambda k: k.launch([x, x, x, 8], tmx.gpu(0),
                                         (1, 1, 1, 1), (8,)), "grid_dims"),
        ("block", lambda k: k.launch([x, x, x, 8], tmx.gpu(0), (1,), ()),
         "block_dims"),
        ("shared", lambda k: k.launch([x, x, x, 8], tmx.gpu(0), (1,), (8,),
                                      -1), "shared_mem must be >= 0"),
        ("cpu context", lambda k: k.launch([x, x, x, 8], tmx.cpu(), (1,),
                                           (8,)), "GPU context"),
    ]


@pytest.mark.parametrize("case", range(len(_bad_launches())),
                         ids=[c[0] for c in _bad_launches()])
def test_fake_bad_launch_raises_before_the_driver(fake_driver, case):
    """Every check raises MXNetError before any driver call, with launches
    unchanged, on a kernel's first launch and after one has launched."""
    name, bad, message = _bad_launches()[case]
    k = tmx.rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel("axpy",
                                                               AXPY_SIG)
    with pytest.raises(MXNetError, match=message):
        bad(k)
    assert fake_driver.calls == [] and k.launches == 0
    x = _cpu(np.ones(8))
    k.launch([x, x, x, 8], tmx.gpu(0), (1,), (8,))
    del fake_driver.calls[:]
    with pytest.raises(MXNetError, match=message):
        bad(k)
    assert fake_driver.calls == [] and k.launches == 1


def test_fake_argument_on_another_device_raises(fake_driver):
    """A pointer argument off the launch context's device raises before the
    driver, naming both devices."""
    x = _cpu(np.ones(8))
    fake_driver.device = torch.device("cuda", 0)
    k = tmx.rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel("axpy",
                                                               AXPY_SIG)
    with pytest.raises(MXNetError, match="lives on cpu, not on the launch "
                       "context's cuda:0"):
        k.launch([x, x, x, 8], tmx.gpu(0), (1,), (8,))
    assert fake_driver.calls == [] and k.launches == 0


def test_fake_failing_launch_raises_with_the_kernel_name(fake_driver):
    k = tmx.rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel("axpy",
                                                               "int n")
    fake_driver.launch_result = 719
    with pytest.raises(MXNetError, match=r"cuLaunchKernel\(axpy\) failed: "
                       "CUDA error 719 \\(CUDA_ERROR_FAKE\\)"):
        k.launch([1], tmx.gpu(0), (1,), (1,))
    assert k.launches == 0


def test_fake_two_threads_launch_their_own_arguments(fake_driver):
    """Two threads inside one kernel's launch at once (the driver holds
    both until both arrived) each pass their own arguments: the parameter
    buffer is the thread's."""
    k = tmx.rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel("axpy",
                                                               AXPY_SIG)
    fake_driver.sizes = [8, 8, 8, 4]
    k.launch([_cpu([0.0])] * 3 + [0], tmx.gpu(0), (1,), (1,))
    fake_driver.barrier = threading.Barrier(2)
    arrays = {n: [_cpu([float(n)]) for _ in range(3)] for n in (1, 2)}
    errors = []

    def run(n):
        try:
            k.launch(arrays[n] + [n], tmx.gpu(0), (n,), (1,))
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(n,)) for n in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    got = {c[3][0]: c[-1] for c in fake_driver.named("cuLaunchKernel")[1:]}
    assert got == {n: [_slot(ctypes.c_uint64, a._data.data_ptr())
                       for a in arrays[n]] + [_slot(ctypes.c_int32, n)]
                   for n in (1, 2)}
    assert k.launches == 3


def test_fake_launcher_that_does_not_build_raises(fake_driver, monkeypatch,
                                                  tmp_path):
    """No other launch path: a launcher that cannot be built raises, and
    nothing is launched."""
    from incubator_mxnet_tpu_torch import cuda_build
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "extension_path",
                        lambda name: tmp_path / "missing.so")
    monkeypatch.setenv("CC", "false")
    k = tmx.rtc.CudaModule(AXPY, exports=["axpy"]).get_kernel("axpy",
                                                               "int n")
    with pytest.raises(MXNetError, match="building _rtc_launch failed"):
        k.launch([1], tmx.gpu(0), (1,), (1,))
    assert fake_driver.named("cuLaunchKernel") == [] and k.launches == 0


def test_fake_floor_launches_from_c(fake_driver):
    """The floor entry issues count launches of the function, with no
    parameters, in the given context and stream, and returns a mean ns."""
    ns = _cuda_driver.launch_floor_ns(0x3000, FakeDriver.CTX0, 5, 0x7000)
    launches = fake_driver.named("cuLaunchKernel")
    assert ns > 0 and len(launches) == 5
    assert {c[2:] for c in launches} == {
        (0x3000, (1, 1, 1), (1, 1, 1), 0, 0x7000, None)}
    assert [c[2] for c in fake_driver.named("cuCtxSetCurrent")] == [
        FakeDriver.CTX0]


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return tmx.gpu(0)


@pytest.fixture
def axpy_module(card):
    return tmx.rtc.CudaModule(AXPY, exports=["axpy", "scale", "noop"])


@pytest.mark.cuda
def test_axpy_matches_jax_oracle(card, axpy_module):
    k = axpy_module.get_kernel("axpy", AXPY_SIG)
    x = tmx.nd.array(np.arange(8, dtype=np.float32), ctx=card)
    o = tmx.nd.zeros(8, ctx=card)
    assert k.launch([x, tmx.nd.ones(8, ctx=card), o, 8], card, (1,),
                    (32,)) is None
    np.testing.assert_array_equal(o.asnumpy(), np.arange(8) * 2.0 + 1)
    assert k.launches == 1


def _pallas_axpy(x_ref, y_ref, o_ref):
    """The JAX build's user kernel, as tests/test_rtc_resume.py writes it."""
    o_ref[...] = x_ref[...] * 2.0 + y_ref[...]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 1000])
def test_axpy_matches_jax_pallas_kernel(card, axpy_module, n):
    """The same x, y through the JAX build's Pallas axpy (interpret mode off
    a TPU) and the port's NVRTC axpy: equal exactly, since 2x is exact in
    f32 and both then round one add (a fused multiply-add included)."""
    rs = np.random.RandomState(n)
    x, y = (rs.standard_normal(n).astype(np.float32) for _ in range(2))
    want = jmx.rtc.PallasModule({"axpy": _pallas_axpy}).get_kernel(
        "axpy").launch([jmx.nd.array(x), jmx.nd.array(y)]).asnumpy()
    k = axpy_module.get_kernel("axpy", AXPY_SIG)
    o = tmx.nd.empty(n, ctx=card)
    k.launch([tmx.nd.array(x, ctx=card), tmx.nd.array(y, ctx=card), o, n],
             card, (-(-n // 256),), (256,))
    np.testing.assert_array_equal(o.asnumpy(), want)
    assert k.launches == 1


@pytest.mark.cuda
def test_non_extern_c_kernel_and_scalars(card, axpy_module):
    k = axpy_module.get_kernel("scale", "double *x, double a, int64_t n")
    x = tmx.nd.array(np.arange(1000, dtype=np.float64), ctx=card,
                     dtype="float64")
    k.launch([x, 0.5, 1000], card, (4,), (256,))
    np.testing.assert_array_equal(x.asnumpy(), np.arange(1000) * 0.5)


@pytest.mark.cuda
def test_bad_arguments_raise(card, axpy_module):
    k = axpy_module.get_kernel("axpy", AXPY_SIG)
    x = tmx.nd.ones(8, ctx=card)
    with pytest.raises(MXNetError, match="takes 4 arguments"):
        k.launch([x, x, x], card, (1,), (8,))
    with pytest.raises(MXNetError, match="must be float32"):
        k.launch([x, tmx.nd.ones(8, ctx=card, dtype="int32"), x, 8], card,
                 (1,), (8,))
    with pytest.raises(MXNetError, match="not contiguous"):
        k.launch([x, x, tmx.nd.NDArray(torch.ones(4, 4, device="cuda").t()),
                  8], card, (1,), (8,))
    with pytest.raises(MXNetError, match="must be a number"):
        k.launch([x, x, x, x], card, (1,), (8,))
    with pytest.raises(MXNetError, match="integer"):
        k.launch([x, x, x, 2.5], card, (1,), (8,))
    with pytest.raises(MXNetError, match="more than 1024"):
        k.launch([x, x, x, 8], card, (1,), (64, 32))
    with pytest.raises(MXNetError, match="grid_dims"):
        k.launch([x, x, x, 8], card, (0,), (8,))
    with tmx.cpu():
        cpu_x = tmx.nd.ones(8)
    with pytest.raises(MXNetError, match="lives on cpu"):
        k.launch([x, cpu_x, x, 8], card, (1,), (8,))
    assert k.launches == 0


@pytest.mark.cuda
def test_compile_error_carries_log(card):
    with pytest.raises(MXNetError, match="undefined_thing"):
        tmx.rtc.CudaModule('extern "C" __global__ void f(float *x) '
                           '{ x[0] = undefined_thing; }', exports=["f"])


@pytest.mark.cuda
def test_one_load_per_device(card, axpy_module):
    k = axpy_module.get_kernel("axpy", AXPY_SIG)
    x = tmx.nd.ones(64, ctx=card)
    o = tmx.nd.zeros(64, ctx=card)
    for _ in range(5):
        k.launch([x, x, o, 64], card, (1,), (64,))
    axpy_module.get_kernel("scale", "double *x, double a, int64_t n")
    assert list(axpy_module._modules) == [0]
    assert list(k._sites) == [0] and k.launches == 5
    np.testing.assert_array_equal(o.asnumpy(), np.full(64, 3.0))


@pytest.mark.cuda
def test_write_bumps_version_for_autograd(card, axpy_module):
    """A tensor autograd saved and a kernel then wrote is caught."""
    k = axpy_module.get_kernel("axpy", AXPY_SIG)
    w = tmx.nd.ones(8, ctx=card)
    w.attach_grad()
    o = tmx.nd.ones(8, ctx=card)
    with tmx.autograd.record():
        y = w * o
    k.launch([w, w, o, 8], card, (1,), (8,))
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        y.backward()


def _current_context():
    ctx = ctypes.c_void_p()
    _cuda_driver.check(_cuda_driver.driver().cuCtxGetCurrent(
        ctypes.byref(ctx)), "cuCtxGetCurrent")
    return ctx.value


@pytest.mark.cuda
def test_launch_from_a_fresh_thread(card, axpy_module):
    """A thread that never touched CUDA has no current context; a launch
    from it (the kernel already launched on the main thread) still runs."""
    k = axpy_module.get_kernel("axpy", AXPY_SIG)
    x = tmx.nd.array(np.arange(8, dtype=np.float32), ctx=card)
    o = tmx.nd.zeros(8, ctx=card)
    k.launch([x, x, o, 8], card, (1,), (32,))
    seen = []

    def run():
        try:
            seen.append(_current_context())
            k.launch([x, tmx.nd.ones(8, ctx=card), o, 8], card, (1,), (32,))
            torch.cuda.synchronize()
        except Exception as exc:  # reported below
            seen.append(exc)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert seen == [None]
    np.testing.assert_array_equal(o.asnumpy(), np.arange(8) * 2.0 + 1)
    assert k.launches == 2


@pytest.mark.cuda
def test_launch_from_a_custom_ops_backward(card, axpy_module):
    """A custom op whose backward launches axpy (in_grad = 2·out_grad + y):
    autograd runs it on its device worker thread, not the caller's."""
    k = axpy_module.get_kernel("axpy", AXPY_SIG)
    threads = []

    class AxpyGrad(tmx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 1.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            threads.append(threading.get_ident())
            k.launch([out_grad[0], in_data[1], in_grad[0],
                      in_grad[0].size], in_grad[0].context, (1,), (32,))

    @tmx.operator.register("rtc_axpy_grad")
    class AxpyGradProp(tmx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data", "y"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return AxpyGrad()

    x = tmx.nd.ones(8, ctx=card)
    y = tmx.nd.array(np.arange(8, dtype=np.float32), ctx=card)
    x.attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.Custom(x, y, op_type="rtc_axpy_grad")
    out.backward(tmx.nd.full(8, 3.0, ctx=card))
    np.testing.assert_array_equal(x.grad.asnumpy(), 6.0 + np.arange(8))
    assert threads and threads[0] != threading.get_ident()
    assert k.launches == 1


@pytest.mark.cuda
def test_launch_under_a_side_stream_is_ordered_on_it(card, axpy_module):
    """Under torch.cuda.stream(s) the launch goes on s: behind a sleep on s
    it has not run when the default stream drains, and a copy on s after it
    reads its result."""
    k = axpy_module.get_kernel("axpy", AXPY_SIG)
    n = 1 << 20
    x = tmx.nd.array(np.arange(n, dtype=np.float32), ctx=card)
    y, o = tmx.nd.ones(n, ctx=card), tmx.nd.zeros(n, ctx=card)
    # the first launch on a device loads the CUBIN (cuModuleLoadData), which
    # may wait for the device: load it before the sleep
    k.launch([x, y, o, n], card, (n // 256,), (256,))
    o._data.zero_()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    snapshot = torch.empty(n, pin_memory=True)
    with torch.cuda.stream(side):
        # allocated before the sleep: a cudaMalloc behind it would wait
        after = torch.empty_like(o._data)
        torch.cuda._sleep(400_000_000)      # ~0.2 s on the card
        k.launch([x, y, o, n], card, (n // 256,), (256,))
        after.copy_(o._data)
    snapshot.copy_(o._data, non_blocking=True)  # on the default stream
    torch.cuda.current_stream().synchronize()
    assert not side.query()
    assert float(snapshot.abs().max()) == 0.0
    side.synchronize()
    want = np.arange(n) * 2.0 + 1
    np.testing.assert_array_equal(after.cpu().numpy(), want)
    np.testing.assert_array_equal(o.asnumpy(), want)


@pytest.mark.cuda
def test_floor_is_below_a_launch(card, axpy_module):
    """The C floor (cuLaunchKernel of noop in a loop from C) is a positive
    time below one CudaKernel.launch of the same kernel."""
    import time
    k = axpy_module.get_kernel("noop", "")
    k.launch([], card, (1,), (1,))
    site = k._sites[0]
    stream = torch.cuda.current_stream().cuda_stream
    floor, launch = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        floor.append(_cuda_driver.launch_floor_ns(site.func, site.ctx, 100,
                                                  stream))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            k.launch([], card, (1,), (1,))
        launch.append((time.perf_counter() - t0) / 100 * 1e9)
    torch.cuda.synchronize()
    assert 0 < min(floor) < min(launch)
