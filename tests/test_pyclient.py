"""annonet_jax.client.ServeClient vs a live in-process annonet_serve —
the Python sidecar analog of tests/test_client.py's C embedding client.

Pins: healthz/model metadata, zero-codec raw inference equal to the
encoded-PNG path and to a hand-rolled urllib request, 2-D grayscale
input into an RGB model, per-request gains (dict and sequence specs
agree), class counts, result-PNG byte compatibility, and error
propagation (client-side validation, server 400 with the server's
message, connection refusal)."""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest

import jax

from annonet_jax import serialization
from annonet_jax.classes import anno_classes_to_json, default_anno_classes
from annonet_jax.cli.serve import build_parser, make_server
from annonet_jax.client import ServeClient, ServeError
from annonet_jax.models.segnet import SegNetConfig, fold_batchnorm, init_state


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    model_path = str(tmp_path_factory.mktemp("pyclient") / "annonet.dnn")
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
    httpd, _service = make_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    yield host, port
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def client(server):
    host, port = server
    return ServeClient(host, port, timeout=60.0)


def _test_image(h=40, w=52, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)


def test_healthz_and_model_info(client):
    health = client.healthz()
    assert health["status"] == "ok"
    assert [c["label"] for c in health["classes"]] == [
        "clean", "minor defect", "major defect"
    ]
    info = client.model_info()
    assert info["model"].endswith("annonet.dnn")
    assert info["classes"] == ["clean", "minor defect", "major defect"]


def test_raw_infer_matches_urllib_and_encoded(client, server):
    image = _test_image()
    labels = client.infer(image)
    assert labels.shape == image.shape[:2]
    assert labels.dtype == np.uint16

    # the same request hand-rolled over urllib (raw path)
    host, port = server
    req = urllib.request.Request(
        f"http://{host}:{port}/infer?format=labels",
        data=np.ascontiguousarray(image).tobytes(), method="POST",
    )
    req.add_header("X-Image-Shape", "40,52,3")
    with urllib.request.urlopen(req, timeout=60) as resp:
        shape = resp.headers["X-Label-Shape"]
        raw = np.frombuffer(resp.read(), "<u2").reshape(
            *(int(v) for v in shape.split(","))
        )
    np.testing.assert_array_equal(labels, raw)

    # the encoded-PNG body path produces the same labels
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    np.testing.assert_array_equal(client.infer(buf.getvalue()), labels)


def test_two_dim_grayscale_input_accepted(client):
    gray = _test_image()[:, :, 0]  # [H, W]
    labels = client.infer(gray)
    # server replicates L->RGB for the RGB model (decode_raw parity)
    np.testing.assert_array_equal(
        labels, client.infer(np.repeat(gray[:, :, None], 3, axis=2))
    )


def test_gains_override_and_spec_forms_agree(client):
    image = _test_image(seed=1)
    base = client.infer(image)
    forced = client.infer(image, gains={2: 1e6})
    assert (forced == 2).all()
    assert not (base == 2).all()
    # dict spec == full-sequence spec
    np.testing.assert_array_equal(
        client.infer(image, gains={1: 0.25}),
        client.infer(image, gains=[0.0, 0.25, 0.0]),
    )


def test_class_counts(client):
    image = _test_image(seed=2)
    counts = client.class_counts(image)
    assert set(counts) == {"clean", "minor defect", "major defect"}
    assert sum(counts.values()) == image.shape[0] * image.shape[1]


def test_infer_png_is_color_coded_mask(client):
    image = _test_image(seed=3)
    png = client.infer_png(image)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    from PIL import Image

    with Image.open(io.BytesIO(png)) as im:
        assert im.size == (image.shape[1], image.shape[0])
        rgba = np.asarray(im.convert("RGBA"))
    # every pixel is one of the default 3-class palette colors
    labels = client.infer(image)
    palette = {c.index: c.rgba_label for c in default_anno_classes()}
    expect = np.stack(
        [np.asarray(palette[int(v)], np.uint8) for v in (0, 1, 2)]
    )[labels]
    np.testing.assert_array_equal(rgba, expect)


def test_client_side_validation(client):
    with pytest.raises(ValueError, match="uint8"):
        client.infer(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="expected"):
        client.infer(np.zeros((8, 8, 4), np.uint8))


def test_server_error_propagates_with_message(client, server):
    host, port = server
    # malformed raw body (shape/body mismatch) -> server 400 with message
    req_error = None
    try:
        ServeClient(host, port)._request(
            "POST", "/infer?format=labels", body=b"xx",
            headers={"X-Image-Shape": "8,8,3"},
        )
    except ServeError as e:
        req_error = e
    assert req_error is not None and req_error.status == 400
    assert "raw body is 2 bytes" in str(req_error)


def test_connection_refused_is_serve_error():
    client = ServeClient("127.0.0.1", 9, timeout=2.0)  # discard port
    with pytest.raises(ServeError, match="cannot reach"):
        client.healthz()


def test_reload_roundtrip(client):
    info = client.reload()
    assert info["status"] == "reloaded"
    assert info["reload_count"] >= 1
