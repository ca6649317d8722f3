"""Native C++ embedding client (native/annonet_client.cpp) vs a live
in-process annonet_serve — the embedding-surface analog of the
reference's annonet_infer.h:15-17 contract.

Builds libannonet_client.so with g++ (skipped when no toolchain), binds
it via ctypes, and drives the real ThreadingHTTPServer: healthz
metadata, encoded-PNG inference equal to the urllib path, the zero-codec
raw-pixel path equal to the PNG path, per-request gains, and error
propagation (connect failure, server 400).
"""

import ctypes
import io
import json
import os
import shutil
import subprocess
import threading
import urllib.request

import numpy as np
import pytest

import jax

from annonet_jax import serialization
from annonet_jax.classes import anno_classes_to_json, default_anno_classes
from annonet_jax.cli.serve import build_parser, make_server
from annonet_jax.models.segnet import SegNetConfig, fold_batchnorm, init_state

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


@pytest.fixture(scope="module")
def client_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    so_path = str(tmp_path_factory.mktemp("client") / "libannonet_client.so")
    src = os.path.join(_NATIVE_DIR, "annonet_client.cpp")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so_path, src],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(so_path)
    lib.annonet_client_create.restype = ctypes.c_void_p
    lib.annonet_client_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.annonet_client_destroy.argtypes = [ctypes.c_void_p]
    lib.annonet_client_last_error.restype = ctypes.c_char_p
    lib.annonet_client_last_error.argtypes = [ctypes.c_void_p]
    lib.annonet_client_healthz.restype = ctypes.c_int
    lib.annonet_client_healthz.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.annonet_client_infer.restype = ctypes.c_int
    lib.annonet_client_infer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.annonet_client_free.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def server_url(tmp_path_factory):
    model_path = str(tmp_path_factory.mktemp("clientsrv") / "annonet.dnn")
    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(
        model_path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64"]
    )
    server, _service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    yield host, port
    server.shutdown()
    server.server_close()


class _Client:
    """Minimal RAII wrapper over the C ABI for the tests."""

    def __init__(self, lib, host, port, timeout_ms=30000):
        self.lib = lib
        self.handle = ctypes.c_void_p(
            lib.annonet_client_create(host.encode(), port, timeout_ms)
        )

    def close(self):
        self.lib.annonet_client_destroy(self.handle)
        self.handle = None

    @property
    def last_error(self):
        return self.lib.annonet_client_last_error(self.handle).decode()

    def healthz(self):
        out = ctypes.c_void_p()
        rc = self.lib.annonet_client_healthz(self.handle, ctypes.byref(out))
        if rc != 0:
            return rc, None
        body = ctypes.cast(out, ctypes.c_char_p).value.decode()
        self.lib.annonet_client_free(out)
        return 0, json.loads(body)

    def infer(self, body, raw_shape=(0, 0, 0), params=None):
        out = ctypes.c_void_p()
        h = ctypes.c_int64()
        w = ctypes.c_int64()
        buf = ctypes.create_string_buffer(bytes(body), len(body))
        rc = self.lib.annonet_client_infer(
            self.handle, buf, len(body),
            raw_shape[0], raw_shape[1], raw_shape[2],
            params.encode() if params else None,
            ctypes.byref(out), ctypes.byref(h), ctypes.byref(w),
        )
        if rc != 0:
            return rc, None
        n = h.value * w.value
        labels = np.ctypeslib.as_array(
            ctypes.cast(out, ctypes.POINTER(ctypes.c_uint16)), shape=(n,)
        ).reshape(h.value, w.value).copy()
        self.lib.annonet_client_free(out)
        return 0, labels


def _png_bytes(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _urllib_labels(host, port, body, query=""):
    req = urllib.request.Request(
        f"http://{host}:{port}/infer?format=labels{query}",
        data=body, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        h, w = (int(v) for v in r.headers["X-Label-Shape"].split(","))
        return np.frombuffer(r.read(), dtype="<u2").reshape(h, w)


def test_healthz_metadata(client_lib, server_url):
    host, port = server_url
    c = _Client(client_lib, host, port)
    try:
        rc, info = c.healthz()
        assert rc == 0, c.last_error
        assert info["status"] == "ok"
        assert [cls["label"] for cls in info["classes"]] == [
            "clean", "minor defect", "major defect"
        ]
    finally:
        c.close()


def test_infer_encoded_matches_urllib(client_lib, server_url):
    host, port = server_url
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 256, size=(80, 96, 3), dtype=np.uint8)
    png = _png_bytes(arr)
    expected = _urllib_labels(host, port, png)
    c = _Client(client_lib, host, port)
    try:
        rc, labels = c.infer(png)
        assert rc == 0, c.last_error
        np.testing.assert_array_equal(labels, expected)
    finally:
        c.close()


def test_infer_raw_matches_encoded(client_lib, server_url):
    host, port = server_url
    rng = np.random.default_rng(8)
    arr = rng.integers(0, 256, size=(72, 88, 3), dtype=np.uint8)
    c = _Client(client_lib, host, port)
    try:
        rc, via_png = c.infer(_png_bytes(arr))
        assert rc == 0, c.last_error
        rc, via_raw = c.infer(arr.tobytes(), raw_shape=arr.shape)
        assert rc == 0, c.last_error
        np.testing.assert_array_equal(via_raw, via_png)
    finally:
        c.close()


def test_infer_with_gain_params(client_lib, server_url):
    host, port = server_url
    rng = np.random.default_rng(9)
    arr = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    png = _png_bytes(arr)
    expected = _urllib_labels(host, port, png, query="&gain=1:25.0")
    c = _Client(client_lib, host, port)
    try:
        rc, labels = c.infer(png, params="gain=1:25.0")
        assert rc == 0, c.last_error
        np.testing.assert_array_equal(labels, expected)
        # a +25 logit gain on class 1 must dominate this tiny random net
        assert (labels == 1).all()
    finally:
        c.close()


def test_raw_shape_mismatch_is_a_clean_400(client_lib, server_url):
    host, port = server_url
    c = _Client(client_lib, host, port)
    try:
        body = bytes(100)
        rc, _ = c.infer(body, raw_shape=(10, 10, 3))  # 300 expected
        assert rc != 0
        assert "raw body" in c.last_error  # client-side length check
        # force it through to the server: lie about the length there too
        rc, _ = c.infer(bytes(10 * 10 * 3), raw_shape=(10, 10, 3),
                        params="format=labels&gain=bogus")
        assert rc != 0
        assert "HTTP 400" in c.last_error
    finally:
        c.close()


def test_connect_failure_reports_error(client_lib):
    c = _Client(client_lib, "127.0.0.1", 1, timeout_ms=2000)
    try:
        rc, _ = c.healthz()
        assert rc != 0
        assert "connect" in c.last_error or "resolve" in c.last_error
    finally:
        c.close()


def test_server_decode_raw_grayscale_conversion():
    """A 3-channel raw body into a grayscale model is converted with
    PIL's exact ITU-R 601-2 math (parity with _ModelService.decode;
    raw==png equality for RGB is covered above)."""
    from PIL import Image

    from annonet_jax.cli.serve import _ModelService

    rng = np.random.default_rng(10)
    arr = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    expected = np.asarray(Image.fromarray(arr).convert("L"), dtype=np.uint8)

    class _Cfg:
        grayscale = True

    class _Svc:
        config = _Cfg()

    got = _ModelService.decode_raw(_Svc(), arr.tobytes(), "16,16,3")
    np.testing.assert_array_equal(got[..., 0], expected)
