"""annonet_serve GET /calibration: download the live int8 calibration.

The export half of the reproducible-deployment loop (an extension
beyond the reference; the reference has no serving analog — its closest surface is
the annonet.dnn artifact round trip, annonet_train_main.cpp:557-565):
an int8 server with no pinned --calibration freezes activation scales on
its first real images; GET /calibration returns exactly those maxima in
the --save-calibration npz format, so an operator can persist them and
restart every replica with --calibration for a bit-identical fleet.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from annonet_jax import serialization
from annonet_jax.classes import anno_classes_to_json, default_anno_classes
from annonet_jax.cli.serve import build_parser, make_server
from annonet_jax.models.segnet import SegNetConfig, fold_batchnorm, init_state

from tests.test_serve import _png_bytes, _post


def _start_server(tmp_path, extra=()):
    model_path = str(tmp_path / "annonet.dnn")
    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(2), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(
        model_path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64", *extra]
    )
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    return f"http://{host}:{port}", server, service


@pytest.fixture(scope="module")
def int8_server(tmp_path_factory):
    url, server, service = _start_server(
        tmp_path_factory.mktemp("servecal"), extra=["--quantize", "int8"]
    )
    yield url, service
    server.shutdown()
    server.server_close()


def _get_error(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            r.read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    raise AssertionError("expected an HTTP error")


def test_calibration_409_before_any_image(int8_server):
    url, _service = int8_server
    code, message = _get_error(url + "/calibration")
    assert code == 409
    assert "no int8 calibration frozen yet" in message


def test_calibration_download_matches_serving_scales(int8_server, tmp_path):
    url, service = int8_server
    # the first real image freezes calibration (--calibration-images 1)
    with _post(url + "/infer?format=labels", _png_bytes(64, 64, seed=3)) as r:
        r.read()
    with urllib.request.urlopen(url + "/calibration", timeout=120) as r:
        assert r.headers["Content-Type"] == "application/octet-stream"
        assert "annonet_calibration.npz" in r.headers.get(
            "Content-Disposition", ""
        )
        body = r.read()

    # the bytes are a valid --calibration file for THIS model: the
    # config and weights-fingerprint checks pass, and the vectors equal
    # what the server is actually serving with
    path = tmp_path / "cal.npz"
    path.write_bytes(body)
    loaded = serialization.load_calibration(
        str(path), service.config, service.params
    )
    exported = service.inferer.export_calibration()
    assert exported is not None
    assert len(loaded) == len(exported)
    for a, b in zip(loaded, exported):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))

    # in-memory bytes are byte-compatible with the file writer
    assert (
        serialization.calibration_npz_bytes(
            exported, service.config, service.params
        )
        == body
    )


def test_calibration_requires_int8_server(tmp_path):
    url, server, _service = _start_server(tmp_path)
    try:
        code, message = _get_error(url + "/calibration")
    finally:
        server.shutdown()
        server.server_close()
    assert code == 409
    assert "--quantize int8" in message


def test_serve_client_calibration_method(int8_server, tmp_path):
    from annonet_jax.client import ServeClient, ServeError

    url, service = int8_server
    host, port = url.removeprefix("http://").rsplit(":", 1)
    client = ServeClient(host, int(port))
    # the fixture's download test may or may not have run yet; one more
    # inference makes the frozen state unconditional here
    with _post(url + "/infer?format=labels", _png_bytes(64, 64, seed=4)) as r:
        r.read()
    body = client.calibration()
    loaded = serialization.load_calibration(
        io.BytesIO(body), service.config, service.params
    )
    exported = service.inferer.export_calibration()
    for a, b in zip(loaded, exported):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_serve_client_calibration_error_payload(tmp_path):
    from annonet_jax.client import ServeClient, ServeError

    url, server, _service = _start_server(tmp_path)
    host, port = url.removeprefix("http://").rsplit(":", 1)
    try:
        with pytest.raises(ServeError) as e:
            ServeClient(host, int(port)).calibration()
    finally:
        server.shutdown()
        server.server_close()
    assert e.value.status == 409
