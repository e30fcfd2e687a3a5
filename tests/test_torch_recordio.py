"""The port's RecordIO against the JAX build's, on the CPU: ``.rec`` and
``.idx`` files byte-identical on the native (``src/io/recordio.cc``) and the
Python framing, read across both ways; the split record above the length
field; ``pack``/``unpack``, ``pack_img``/``unpack_img``; records that
``tools/im2rec.py`` packs; pickling; a failed native build and OpenCV's
absence raise ``MXNetError``."""
import importlib.util
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from incubator_mxnet_tpu import recordio as jrec
from incubator_mxnet_tpu import _native as jnative
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import _native as tnative
from incubator_mxnet_tpu_torch import cuda_build
from incubator_mxnet_tpu_torch import recordio as trec
from incubator_mxnet_tpu_torch.base import MXNetError

ROOT = Path(__file__).resolve().parent.parent


def _native_env(monkeypatch, on):
    monkeypatch.setenv("MXTPU_NATIVE_IO", "1" if on else "0")


def _payloads(seed=0, n=9):
    """Records of every length modulo 4 (the padding), an empty one, array
    labels (``flag`` > 0) and scalar ones."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        body = rs.bytes(rs.randint(0, 300) if i else 0)
        label = float(i % 5) if i % 2 else \
            rs.standard_normal(i % 4 + 1).astype(np.float32)
        out.append((jrec.IRHeader(0, label, i, 7 * i), body))
    return out


def _write(mod, prefix, payloads):
    w = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for hdr, body in payloads:
        w.write_idx(hdr.id, mod.pack(hdr, body))
    w.close()
    return w._native_handle


def _read_all(mod, path):
    r = mod.MXRecordIO(path, "r")
    out = []
    while True:
        s = r.read()
        if s is None:
            break
        out.append(bytes(s))
    r.close()
    return out


@pytest.mark.parametrize("jax_native", [True, False])
@pytest.mark.parametrize("port_native", [True, False])
def test_files_byte_identical(tmp_path, monkeypatch, jax_native, port_native):
    assert jnative.available()
    payloads = _payloads()
    _native_env(monkeypatch, jax_native)
    assert _write(jrec, str(tmp_path / "j"), payloads) is jax_native
    _native_env(monkeypatch, port_native)
    assert _write(trec, str(tmp_path / "t"), payloads) is port_native
    for ext in (".rec", ".idx"):
        assert (tmp_path / ("t" + ext)).read_bytes() == \
            (tmp_path / ("j" + ext)).read_bytes()


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)])
@pytest.mark.parametrize("native", [True, False])
def test_cross_reads(tmp_path, monkeypatch, writer, reader, native):
    """Each package reads the other's file, sequentially and by key, on
    either framing."""
    payloads = _payloads(1)
    _native_env(monkeypatch, True)
    prefix = str(tmp_path / "x")
    _write(writer, prefix, payloads)
    _native_env(monkeypatch, native)
    want = [writer.pack(h, b) for h, b in payloads]
    assert _read_all(reader, prefix + ".rec") == want
    r = reader.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    assert r._native_handle is native
    assert r.keys == [h.id for h, _ in payloads]
    for key in (5, 0, 8, 3):
        hdr, body = reader.unpack(r.read_idx(key))
        want_hdr, want_body = payloads[key]
        assert body == want_body and hdr.id == want_hdr.id
        assert hdr.id2 == want_hdr.id2
        np.testing.assert_array_equal(hdr.label, want_hdr.label)
    r.close()


def test_multipart_record_roundtrip(tmp_path, monkeypatch):
    """Payloads over the length field split into begin, middle and end
    parts: the Python writers of both packages write the same bytes, and
    the Python and native readers of both join them."""
    payloads = [b"x" * 10, b"y" * 321, b"z" * 100, b"w" * 205]
    _native_env(monkeypatch, False)
    for mod, name in ((jrec, "j"), (trec, "t")):
        monkeypatch.setattr(mod, "_MAX_REC_LEN", 100)
        w = mod.MXRecordIO(str(tmp_path / (name + ".rec")), "w")
        assert not w._native_handle
        for pl in payloads:
            w.write(pl)
        w.close()
    data = (tmp_path / "t.rec").read_bytes()
    assert data == (tmp_path / "j.rec").read_bytes()
    # 1 + 4 + 1 + 3 parts, each with an 8-byte head
    assert len(data) == sum(len(p) + (-len(p)) % 4 for p in payloads) + 8 * 9
    assert _read_all(trec, str(tmp_path / "t.rec")) == payloads
    _native_env(monkeypatch, True)
    assert _read_all(trec, str(tmp_path / "t.rec")) == payloads
    nr = tnative.NativeRecordReader(str(tmp_path / "j.rec"))
    got = []
    while True:
        s = nr.read()
        if s is None:
            break
        got.append(s)
    nr.close()
    nr.close()                      # idempotent
    assert got == payloads


def test_truncated_split_record_raises(tmp_path, monkeypatch):
    _native_env(monkeypatch, False)
    monkeypatch.setattr(trec, "_MAX_REC_LEN", 8)
    path = str(tmp_path / "cut.rec")
    w = trec.MXRecordIO(path, "w")
    w.write(b"a" * 20)
    w.close()
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[:-12])      # drop the end part
    with pytest.raises(IOError, match="split record"):
        _read_all(trec, path)


def test_prefetch_reader_and_tell_seek(tmp_path, monkeypatch):
    payloads = _payloads(2)
    _native_env(monkeypatch, True)
    prefix = str(tmp_path / "p")
    _write(trec, prefix, payloads)
    want = [trec.pack(h, b) for h, b in payloads]
    for capacity in (1, 3, 64):
        pr = tnative.NativePrefetchReader(prefix + ".rec", capacity)
        got = [pr.read() for _ in range(len(want) + 2)]
        pr.close()
        assert got == want + [None, None]
    for native in (True, False):
        _native_env(monkeypatch, native)
        r = trec.MXRecordIO(prefix + ".rec", "r")
        r.read()
        pos = r.tell()
        second = r.read()
        r.reset()
        assert r.read() == want[0]
        r.handle.seek(pos)
        assert r.read() == second == want[1]
        r.close()
    with pytest.raises(IOError, match="cannot open"):
        tnative.NativeRecordReader(str(tmp_path / "missing.rec"))
    with pytest.raises(ValueError, match="Invalid flag"):
        trec.MXRecordIO(prefix + ".rec", "a")


def test_pack_unpack_match_jax():
    for hdr, body in _payloads(3):
        s = trec.pack(hdr, body)
        assert s == jrec.pack(hdr, body)
        got, rest = trec.unpack(s)
        want, wrest = jrec.unpack(s)
        assert rest == wrest == body
        assert (got.flag, got.id, got.id2) == (want.flag, want.id, want.id2)
        np.testing.assert_array_equal(got.label, want.label)
    assert trec.IRHeader._fields == jrec.IRHeader._fields


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_pack_img_matches_jax(fmt):
    pytest.importorskip("cv2")
    img = (np.random.RandomState(4).rand(12, 10, 3) * 255).astype(np.uint8)
    hdr = trec.IRHeader(0, 3.0, 1, 0)
    s = trec.pack_img(hdr, img, quality=90, img_fmt=fmt)
    assert s == jrec.pack_img(hdr, img, quality=90, img_fmt=fmt)
    got_hdr, got = trec.unpack_img(s)
    want_hdr, want = jrec.unpack_img(s)
    assert got_hdr == want_hdr
    np.testing.assert_array_equal(got, want)


def test_opencv_paths_raise_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(MXNetError, match="OpenCV"):
        trec.pack_img(trec.IRHeader(0, 0.0, 0, 0), img)
    with pytest.raises(MXNetError, match="OpenCV"):
        trec.unpack_img(trec.pack(trec.IRHeader(0, 0.0, 0, 0), b"\x89PNG"))


def test_pickle_reopens(tmp_path, monkeypatch):
    _native_env(monkeypatch, True)
    prefix = str(tmp_path / "k")
    payloads = _payloads(5)
    _write(trec, prefix, payloads)
    r = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.is_open and r2.keys == r.keys
    assert r2.read_idx(4) == trec.pack(*payloads[4])
    # pickling closes the original, as MXNet's does: a read raises
    assert not r.is_open
    with pytest.raises(IOError, match="closed"):
        r.handle.read()
    r.reset()
    assert r.read_idx(4) == trec.pack(*payloads[4])
    r.close()
    r2.close()


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """With NATIVE_IO on, a build that fails raises with the compiler's
    output; nothing falls back to the Python framing."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "HOST_LIBS",
                        {"recordio": tmp_path / "broken.cc"})
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_LIB", [])
    monkeypatch.delitem(cuda_build._LIBS, "recordio", raising=False)
    _native_env(monkeypatch, True)
    with pytest.raises(MXNetError, match="broken.cc"):
        trec.MXRecordIO(str(tmp_path / "a.rec"), "w")
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _name: None)
    with pytest.raises(MXNetError, match="C\\+\\+ compiler"):
        trec.MXRecordIO(str(tmp_path / "a.rec"), "w")
    _native_env(monkeypatch, False)
    w = trec.MXRecordIO(str(tmp_path / "a.rec"), "w")
    assert not w._native_handle
    w.close()


def test_native_library_is_built_from_the_repository_source():
    lib = tnative.io_lib()
    path = cuda_build.host_lib_path("recordio")
    assert path.parent == cuda_build.BUILD_DIR and path.exists()
    assert cuda_build.HOST_LIBS["recordio"] == ROOT / "src" / "io" / \
        "recordio.cc"
    assert lib is tnative.io_lib()
    assert not (ROOT / "incubator_mxnet_tpu_torch" / "csrc" /
                "recordio.cc").exists()


def _im2rec():
    spec = importlib.util.spec_from_file_location(
        "im2rec_tool", ROOT / "tools" / "im2rec.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("pack_raw", [True, False])
def test_reads_what_im2rec_packs(tmp_path, monkeypatch, pack_raw):
    """``tools/im2rec.py`` (the JAX build's) packs a two-class folder, raw
    or PNG; the port's ImageIter reads the same pixels and labels."""
    cv2 = pytest.importorskip("cv2")
    rs = np.random.RandomState(6)
    imgs = {}
    for cls in ("cat", "dog"):
        (tmp_path / "root" / cls).mkdir(parents=True)
        for i in range(3):
            img = (rs.rand(8, 8, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(tmp_path / "root" / cls / ("%d.png" % i)),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            imgs[cls + "/%d.png" % i] = img
    tool = _im2rec()
    prefix = str(tmp_path / "pack")
    root = str(tmp_path / "root")
    tool.write_list(prefix + ".lst", list(tool.list_images(root, True)))
    tool.make_record(prefix, root, types.SimpleNamespace(
        pass_through=False, resize=0, center_crop=False, pack_raw=pack_raw,
        quality=3, encoding=".png"))
    listed = [line.split("\t") for line in
              Path(prefix + ".lst").read_text().splitlines()]
    with tmx.cpu():
        it = tmx.image.ImageIter(batch_size=6, data_shape=(3, 8, 8),
                                 path_imgrec=prefix + ".rec",
                                 path_imgidx=prefix + ".idx", aug_list=[],
                                 decode="raw" if pack_raw else "auto")
        batch = it.next()
    data = batch.data[0].asnumpy()
    for j, (_, label, rel) in enumerate(listed):
        np.testing.assert_array_equal(data[j], imgs[rel].transpose(2, 0, 1))
        assert batch.label[0].asnumpy()[j] == float(label)
