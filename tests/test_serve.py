"""annonet_serve: in-process HTTP server tests (extension beyond the reference).

Drives the real ThreadingHTTPServer on an ephemeral port with urllib —
the same request path production clients use.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from annonet_jax import serialization
from annonet_jax.classes import default_anno_classes, anno_classes_to_json
from annonet_jax.cli.serve import build_parser, make_server
from annonet_jax.models.segnet import SegNetConfig, fold_batchnorm, init_state


@pytest.fixture(scope="module")
def server_url(tmp_path_factory):
    model_path = str(tmp_path_factory.mktemp("serve") / "annonet.dnn")
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
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}", service
    server.shutdown()
    server.server_close()


def _png_bytes(h=80, w=96, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body, **kw):
    req = urllib.request.Request(url, data=body, method="POST", **kw)
    return urllib.request.urlopen(req, timeout=120)


def test_healthz_reports_model_metadata(server_url):
    url, _service = server_url
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert info["status"] == "ok"
    assert info["downscaling_factor"] == 1.0
    assert info["quantize"] == "none"
    assert [c["label"] for c in info["classes"]] == [
        "clean", "minor defect", "major defect"
    ]
    assert info["required_input_dimension"] > 0


def test_infer_png_roundtrip(server_url):
    from PIL import Image

    url, _service = server_url
    with _post(url + "/infer", _png_bytes(80, 96)) as r:
        assert r.headers["Content-Type"] == "image/png"
        assert float(r.headers["X-Inference-Ms"]) > 0
        png = r.read()
    with Image.open(io.BytesIO(png)) as im:
        assert im.mode == "RGBA"
        assert im.size == (96, 80)  # original size, (w, h)


def test_infer_labels_format(server_url):
    url, _service = server_url
    with _post(url + "/infer?format=labels", _png_bytes(64, 64)) as r:
        assert r.headers["Content-Type"] == "application/octet-stream"
        assert r.headers["X-Label-Shape"] == "64,64"
        labels = np.frombuffer(r.read(), dtype="<u2").reshape(64, 64)
    assert labels.max() < 3


def test_infer_counts_format_and_gain_override(server_url):
    url, _service = server_url
    with _post(url + "/infer?format=counts", _png_bytes(64, 64)) as r:
        counts = json.loads(r.read())["counts"]
    assert sum(counts.values()) == 64 * 64
    assert set(counts) == {"clean", "minor defect", "major defect"}

    # an extreme gain forces every pixel to that class (logit-space add,
    # annonet_infer.cpp:170-185)
    with _post(
        url + "/infer?format=counts&gain=2:1000", _png_bytes(64, 64)
    ) as r:
        counts = json.loads(r.read())["counts"]
    assert counts["major defect"] == 64 * 64


def test_infer_detection_levels_run_blob_veto(server_url):
    url, _service = server_url
    with _post(
        url + "/infer?format=labels&detection=1:0.5&detection=2:0.5",
        _png_bytes(64, 64),
    ) as r:
        labels = np.frombuffer(r.read(), dtype="<u2").reshape(64, 64)
    assert labels.max() < 3


def test_bad_requests_are_400_not_500(server_url):
    url, _service = server_url
    for path, body in [
        ("/infer", b"this is not an image"),
        ("/infer?format=bogus", _png_bytes()),
        ("/infer?gain=notaclass", _png_bytes()),
        ("/infer", b""),
    ]:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post(url + path, body)
        assert exc_info.value.code == 400
        assert "error" in json.loads(exc_info.value.read())


def test_unknown_route_is_404(server_url):
    url, _service = server_url
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert exc_info.value.code == 404


def test_concurrent_requests_serialize_on_device(server_url):
    url, service = server_url
    before = service.requests_served
    errors = []

    def one(seed):
        try:
            with _post(
                url + "/infer?format=counts", _png_bytes(seed=seed)
            ) as r:
                assert r.status == 200
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=one, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert service.requests_served == before + 6


@pytest.fixture(scope="module")
def batched_server(tmp_path_factory):
    model_path = str(tmp_path_factory.mktemp("serveb") / "annonet.dnn")
    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(1), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(
        model_path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64",
         "--max-batch", "4", "--batch-window-ms", "500"]
    )
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}", service
    server.shutdown()
    server.server_close()


def test_dynamic_batching_groups_concurrent_requests(batched_server):
    """--max-batch groups concurrent same-shape requests into one device
    batch; per-request results must equal unbatched inference."""
    url, service = batched_server

    # warm: a single request compiles the batch-1 program (and drains the
    # window path once)
    with _post(url + "/infer?format=labels", _png_bytes(64, 64, seed=9)) as r:
        warm = np.frombuffer(r.read(), dtype="<u2").reshape(64, 64)

    before_batches = service.batches_dispatched
    results = {}
    errors = []

    def one(seed):
        try:
            with _post(
                url + "/infer?format=labels", _png_bytes(64, 64, seed=seed)
            ) as r:
                results[seed] = np.frombuffer(
                    r.read(), dtype="<u2"
                ).reshape(64, 64)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=one, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(results) == 4
    # fewer device dispatches than requests -> at least one real batch
    dispatched = service.batches_dispatched - before_batches
    assert 1 <= dispatched < 4

    # per-request results equal the unbatched single-request path
    for seed in range(4):
        with _post(
            url + "/infer?format=labels", _png_bytes(64, 64, seed=seed)
        ) as r:
            single = np.frombuffer(r.read(), dtype="<u2").reshape(64, 64)
        np.testing.assert_array_equal(results[seed], single)

    # mixed shapes split into separate groups but still succeed
    with _post(url + "/infer?format=labels", _png_bytes(48, 80)) as r:
        assert r.headers["X-Label-Shape"] == "48,80"
    assert warm.shape == (64, 64)


def test_serve_with_mesh(tmp_path):
    """--mesh N serves tile-parallel over the (virtual 8-device) mesh."""
    model_path = str(tmp_path / "annonet.dnn")
    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(2), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(
        model_path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0", "--mesh", "8",
         "--tile-max-width", "64", "--tile-max-height", "64"]
    )
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        url = f"http://{host}:{port}"
        with _post(url + "/infer?format=labels", _png_bytes(80, 80)) as r:
            labels = np.frombuffer(r.read(), dtype="<u2").reshape(80, 80)
        assert labels.max() < 3

        # mesh results equal single-device results exactly
        args1 = build_parser().parse_args(
            ["--model", model_path, "--port", "0",
             "--tile-max-width", "64", "--tile-max-height", "64"]
        )
        from annonet_jax.cli.serve import _ModelService

        single = _ModelService(args1)
        image = single.decode(_png_bytes(80, 80))
        expected = single.infer(
            image, single.default_gains, single.default_detection
        )
        np.testing.assert_array_equal(labels, expected)
    finally:
        server.shutdown()
        server.server_close()


def test_warmup_precompiles_and_rejects_bad_spec(tmp_path, capsys):
    """--warmup HxW pre-compiles the program for that size (a following
    request of the same size hits the cache); bad specs exit 1 with a
    message, not a traceback."""
    model_path = str(tmp_path / "annonet.dnn")
    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(3), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(
        model_path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    from annonet_jax.cli.serve import _ModelService, _warmup, build_parser

    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64"]
    )
    service = _ModelService(args)
    _warmup(service, ["72x80"])
    # warm-up passes are NOT served requests: they must not pollute the
    # /stats counters/percentiles with their compile latencies
    assert service.requests_served == 0
    assert len(service.inferer._compiled) >= 1

    with pytest.raises(RuntimeError, match="bad --warmup size"):
        _warmup(service, ["72by80"])
    with pytest.raises(RuntimeError, match="bad --warmup size"):
        _warmup(service, ["0x80"])


def test_stats_endpoint_reports_latency_percentiles(server_url):
    url, service = server_url
    with _post(url + "/infer?format=labels", _png_bytes(64, 64)) as r:
        r.read()
    with urllib.request.urlopen(url + "/stats", timeout=60) as r:
        stats = json.loads(r.read())
    assert stats["requests_served"] >= 1
    assert stats["latency_window"] >= 1
    lat = stats["latency_ms"]
    assert lat["p50"] is not None and lat["p50"] > 0
    assert lat["max"] >= lat["p50"]
    assert stats["compiled_programs"] >= 1


def test_warmup_does_not_calibrate_int8_on_synthetic_gray(tmp_path, capsys):
    """--warmup with --quantize int8 and NO persisted calibration must not
    freeze activation scales on the flat gray warm-up image (that would
    silently clip every real request); calibration belongs to the first
    real image."""
    from annonet_jax.cli.serve import _ModelService, _warmup

    model_path = str(tmp_path / "annonet.dnn")
    config = SegNetConfig(class_count=3, level_count=0, base_width=16)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(
        model_path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    args = build_parser().parse_args(
        ["--model", model_path, "--quantize", "int8",
         "--tile-max-width", "64", "--tile-max-height", "64"]
    )
    service = _ModelService(args)
    _warmup(service, ["64x64"])
    out = capsys.readouterr().out
    assert "float program only" in out
    # nothing frozen, nothing accumulated from the gray image
    assert not service.inferer._calib_frozen
    assert not service.inferer._calib_seen
    # a real image then calibrates and freezes as usual
    rng = np.random.default_rng(0)
    real = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    service.infer(real, service.default_gains, service.default_detection)
    assert service.inferer._calib_frozen


def _save_model(path, seed, config=None):
    config = config or SegNetConfig(class_count=3, level_count=0,
                                    base_width=16)
    params, bn = init_state(jax.random.PRNGKey(seed), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(
        path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    return runtime, config


def test_reload_hot_swaps_to_retrained_model(tmp_path):
    """POST /reload picks up the artifact on disk (the trainer's periodic
    annonet.dnn snapshot) without dropping the server."""
    model_path = str(tmp_path / "annonet.dnn")
    _save_model(model_path, seed=0)
    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64"]
    )
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        url = f"http://{host}:{port}"
        png = _png_bytes(80, 80, seed=4)
        with _post(url + "/infer?format=labels", png) as r:
            before = np.frombuffer(r.read(), dtype="<u2").reshape(80, 80)

        # "retrain": a different model lands at the same path
        runtime_b, config_b = _save_model(model_path, seed=9)
        programs_before = len(service.state.inferer._compiled)
        with _post(url + "/reload", b"") as r:
            info = json.loads(r.read())
        assert info["status"] == "reloaded"
        assert info["reload_count"] == 1
        # same architecture -> the weight-swap fast path: the serving
        # inferer is reused and every compiled program is kept
        assert info["fast_swap"] is True
        assert len(service.state.inferer._compiled) == programs_before

        with urllib.request.urlopen(url + "/model", timeout=30) as r:
            model_info = json.loads(r.read())
        assert model_info["reload_count"] == 1

        with _post(url + "/infer?format=labels", png) as r:
            after = np.frombuffer(r.read(), dtype="<u2").reshape(80, 80)

        # the new model's labels match a fresh local inferer on model B
        from annonet_jax.infer.core import TiledInferer, annonet_infer
        from annonet_jax.infer.tiling import TilingParameters
        from annonet_jax.models.segnet import required_input_dimension

        ov = required_input_dimension(config_b)
        local = TiledInferer(
            runtime_b, config_b, TilingParameters(64, 64, ov, ov)
        )
        expected = annonet_infer(local, service.decode(png))
        np.testing.assert_array_equal(after, expected)
        assert before.shape == after.shape
    finally:
        server.shutdown()
        server.server_close()


def test_reload_failure_keeps_old_model(tmp_path):
    model_path = str(tmp_path / "annonet.dnn")
    _save_model(model_path, seed=0)
    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64"]
    )
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        url = f"http://{host}:{port}"
        png = _png_bytes(64, 64, seed=1)
        with _post(url + "/infer?format=labels", png) as r:
            before = np.frombuffer(r.read(), dtype="<u2")

        with open(model_path, "wb") as f:
            f.write(b"not a model")
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post(url + "/reload", b"")
        assert exc_info.value.code == 409

        # old model still serves, identically
        with _post(url + "/infer?format=labels", png) as r:
            after = np.frombuffer(r.read(), dtype="<u2")
        np.testing.assert_array_equal(before, after)
        with urllib.request.urlopen(url + "/model", timeout=30) as r:
            assert json.loads(r.read())["reload_count"] == 0
    finally:
        server.shutdown()
        server.server_close()


def test_reload_stale_calibration_needs_recalibrate(tmp_path):
    """A retrained artifact fails fingerprint-checked --calibration reload
    (409, old model keeps serving); ?recalibrate=1 drops the file and
    recalibrates at runtime."""
    from annonet_jax.infer.core import TiledInferer
    from annonet_jax.infer.tiling import TilingParameters
    from annonet_jax.models.segnet import required_input_dimension

    model_path = str(tmp_path / "annonet.dnn")
    calib_path = str(tmp_path / "calib.npz")
    runtime_a, config = _save_model(model_path, seed=0)

    ov = required_input_dimension(config)
    calibrator = TiledInferer(
        runtime_a, config, TilingParameters(64, 64, ov, ov),
        quantize="int8",
    )
    rng = np.random.default_rng(0)
    calibrator.infer_arrays(
        rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    )
    serialization.save_calibration(
        calib_path, calibrator.export_calibration(), config,
        runtime_params=runtime_a,
    )

    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0", "--quantize", "int8",
         "--calibration", calib_path,
         "--tile-max-width", "64", "--tile-max-height", "64"]
    )
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        url = f"http://{host}:{port}"

        _save_model(model_path, seed=5)  # retrained weights
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            _post(url + "/reload", b"")
        assert exc_info.value.code == 409
        assert "calibrated for different trained weights" in json.loads(
            exc_info.value.read()
        )["error"]

        with _post(url + "/reload?recalibrate=1", b"") as r:
            info = json.loads(r.read())
        assert info["status"] == "reloaded"
        assert info["recalibrate"] is True

        png = _png_bytes(64, 64, seed=2)
        with _post(url + "/infer?format=labels", png) as r:
            labels = np.frombuffer(r.read(), dtype="<u2")
        assert labels.max() < 3
    finally:
        server.shutdown()
        server.server_close()


def test_keepalive_survives_reload_and_404_with_body(tmp_path):
    """Routes that ignore the request body must still drain it, or a
    keep-alive connection desyncs for the next request."""
    import http.client

    model_path = str(tmp_path / "annonet.dnn")
    _save_model(model_path, seed=0)
    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64"]
    )
    server, _service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=60)
        body = b"x" * 4096
        conn.request("POST", "/reload", body=body)
        assert conn.getresponse().read()  # 200, drained
        conn.request("POST", "/nonexistent", body=body)
        r = conn.getresponse()
        assert r.status == 404
        r.read()
        # the SAME connection still works for a real request
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200
        assert json.loads(r.read())["status"] == "ok"
        conn.close()
    finally:
        server.shutdown()
        server.server_close()


def test_metrics_endpoint_prometheus_format(server_url):
    """GET /metrics exposes the /stats content in Prometheus exposition
    format: counters, gauges, and windowed latency quantiles."""
    url, service = server_url
    with _post(url + "/infer?format=labels", _png_bytes(64, 64)) as r:
        r.read()
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode("utf-8")
    assert "# TYPE annonet_requests_served_total counter" in body
    assert "# TYPE annonet_request_latency_seconds gauge" in body
    served = [
        line for line in body.splitlines()
        if line.startswith("annonet_requests_served_total ")
    ]
    assert served and int(served[0].split()[1]) >= 1
    q50 = [
        line for line in body.splitlines()
        if line.startswith('annonet_request_latency_seconds{quantile="0.5"}')
    ]
    assert q50 and float(q50[0].split()[1]) > 0
    # exposition format: every non-comment line is "name[{labels}] value"
    for line in body.splitlines():
        if line.startswith("#") or not line:
            continue
        parts = line.rsplit(" ", 1)
        assert len(parts) == 2 and float(parts[1]) >= 0, line


def test_reload_config_change_takes_full_rebuild_path(tmp_path):
    """A reload to a DIFFERENT architecture cannot reuse the serving
    inferer: fast_swap is false, a new inferer is built, and requests
    serve the new class count."""
    model_path = str(tmp_path / "annonet.dnn")
    _save_model(model_path, seed=0)
    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64"]
    )
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        url = f"http://{host}:{port}"
        old_inferer = service.state.inferer

        config = SegNetConfig(class_count=4, level_count=0, base_width=16)
        params, bn = init_state(jax.random.PRNGKey(3), config)
        serialization.save_model(
            model_path, fold_batchnorm(params, bn, config), config,
            anno_classes_to_json(
                default_anno_classes()
                + [type(default_anno_classes()[0])(3, (9, 9, 9, 30), "x")]
            ),
            1.0,
        )
        with _post(url + "/reload", b"") as r:
            info = json.loads(r.read())
        assert info["status"] == "reloaded"
        assert info["fast_swap"] is False
        assert info["class_count"] == 4
        assert service.state.inferer is not old_inferer

        with _post(url + "/infer?format=counts", _png_bytes(64, 64)) as r:
            counts = json.loads(r.read())
        assert len(counts["counts"]) == 4
    finally:
        server.shutdown()
        thread.join(timeout=10)


def test_watch_model_auto_reloads_on_mtime_change(tmp_path):
    """--watch-model polls the artifact's mtime and auto-reloads —
    same-architecture snapshots take the weight-swap fast path."""
    import os
    import time as _time

    model_path = str(tmp_path / "annonet.dnn")
    _save_model(model_path, seed=0)
    args = build_parser().parse_args(
        ["--model", model_path, "--port", "0",
         "--tile-max-width", "64", "--tile-max-height", "64",
         "--watch-model", "0.05"]
    )
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    stop = service.start_model_watch(0.05)
    try:
        old_inferer = service.state.inferer
        _save_model(model_path, seed=9)
        # force an mtime change even on coarse-granularity filesystems
        os.utime(model_path, (os.path.getmtime(model_path) + 2,) * 2)
        deadline = _time.monotonic() + 15.0
        while (service.state.reload_count == 0
               and _time.monotonic() < deadline):
            _time.sleep(0.05)
        assert service.state.reload_count == 1
        assert service.state.inferer is old_inferer  # fast swap
    finally:
        stop.set()
        server.shutdown()
        thread.join(timeout=10)


def test_device_stall_indicator(server_url):
    """While a device section is in flight longer than
    --device-stall-seconds, /healthz reports status "stalled" with HTTP
    503 and /metrics raises annonet_device_stalled — the mid-serving
    analog of the startup device_probe (a wedged device op cannot be
    cancelled; the server signals load balancers instead). Uses the
    _device_section bookkeeping directly so the test is deterministic."""
    url, service = server_url

    def get_health():
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode())

    # idle: ok, no busy age
    code, health = get_health()
    assert (code, health["status"]) == (200, "ok")
    assert health["device_busy_seconds"] is None

    old_threshold = service.device_stall_seconds
    service.device_stall_seconds = 1.0  # floor value
    entered = threading.Event()
    release = threading.Event()

    def hold_device_section():
        with service._device_section():
            entered.set()
            release.wait(timeout=60)

    holder = threading.Thread(target=hold_device_section, daemon=True)
    holder.start()
    try:
        assert entered.wait(timeout=10)
        # below the threshold: still ok, but busy age is visible
        code, health = get_health()
        assert code == 200 and health["device_busy_seconds"] >= 0.0
        time.sleep(1.2)
        code, health = get_health()
        assert (code, health["status"]) == (503, "stalled")
        assert health["device_busy_seconds"] > 1.0
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            body = r.read().decode()
        assert "annonet_device_stalled 1" in body
        # both embedding clients keep working against the 503: the Python
        # sidecar client returns the payload (callers read status)...
        from annonet_jax.client import ServeClient

        host, port = url.rsplit("//", 1)[1].split(":")
        payload = ServeClient(host, int(port), timeout=30).healthz()
        assert payload["status"] == "stalled"
    finally:
        release.set()
        holder.join(timeout=10)
        service.device_stall_seconds = old_threshold

    # released: healthy again
    code, health = get_health()
    assert (code, health["status"]) == (200, "ok")
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        assert "annonet_device_stalled 0" in r.read().decode()


def test_device_sections_cover_all_request_paths():
    """Every lock-held device op must ride _device_section (the stall
    bookkeeping): the single-image pass, the dynamic-batching dispatch,
    and the reload fast-path weight swap."""
    import inspect

    from annonet_jax.cli import serve as serve_mod

    src = inspect.getsource(serve_mod._ModelService)
    assert src.count("with self._device_section(") >= 3
    # request paths must not bypass the bookkeeping with the raw lock
    for fn in (serve_mod._ModelService._device_pass,
               serve_mod._ModelService._dispatch_loop):
        assert "with self.device_lock:" not in inspect.getsource(fn)


def test_first_shape_compile_grace(server_url):
    """The FIRST device section for a given input shape carries the lazy
    XLA compile, so it gets compile_grace_seconds extra allowance before
    reading as a stall; repeat sections of the same shape get only
    --device-stall-seconds."""
    _url, service = server_url
    old = service.device_stall_seconds
    service.device_stall_seconds = 1.0
    key = ("test-grace", (32, 32, 3))
    entered = threading.Event()
    release = threading.Event()

    def hold(section_key):
        with service._device_section(key=section_key):
            entered.set()
            release.wait(timeout=60)

    try:
        # first section of this shape: within grace, never stalled
        holder = threading.Thread(target=hold, args=(key,), daemon=True)
        holder.start()
        assert entered.wait(timeout=10)
        time.sleep(1.2)  # > stall threshold, << grace
        assert service.device_busy_seconds() > 1.0
        assert not service.device_stalled()
        release.set()
        holder.join(timeout=10)

        # the same shape again: plain allowance applies
        entered.clear()
        release.clear()
        holder = threading.Thread(target=hold, args=(key,), daemon=True)
        holder.start()
        assert entered.wait(timeout=10)
        time.sleep(1.2)
        assert service.device_stalled()
    finally:
        release.set()
        holder.join(timeout=10)
        service.device_stall_seconds = old


def test_max_rss_guard_turns_health_red(tmp_path):
    """--max-rss-mb: once host RSS passes the limit, healthz reports
    'rss-exceeded' (HTTP 503 — replica rotated out) and /metrics exports
    the gauge. Built for transports whose PJRT client leaks per-upload
    staging buffers (docs/SERVING.md 'Host RSS'); 0 disables."""
    model_path = str(tmp_path / "annonet.dnn")
    config = SegNetConfig(class_count=3, level_count=0, base_width=8)
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    serialization.save_model(
        model_path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    from annonet_jax.cli.serve import (
        _ModelService, _process_rss_mb, build_parser,
    )

    base = ["--model", model_path, "--port", "0",
            "--tile-max-width", "64", "--tile-max-height", "64"]

    # default: off — even though RSS is obviously > 0
    service = _ModelService(build_parser().parse_args(base))
    assert _process_rss_mb() > 1.0
    assert service.healthz()["status"] == "ok"
    assert "annonet_rss_exceeded 0" in service.metrics_text()
    assert service.stats()["rss_mb"] > 1.0

    # a 1 MB limit is below any real process RSS -> red
    service = _ModelService(
        build_parser().parse_args([*base, "--max-rss-mb", "1"])
    )
    assert service.rss_exceeded()
    assert service.healthz()["status"] == "rss-exceeded"
    assert "annonet_rss_exceeded 1" in service.metrics_text()

    # a huge limit -> ok
    service = _ModelService(
        build_parser().parse_args([*base, "--max-rss-mb", "1000000"])
    )
    assert service.healthz()["status"] == "ok"


def test_serve_reference_blend_semantics_flag(tmp_path):
    """--reference-blend-semantics plumbs through to the TiledInferer
    (the serve-side of the infer CLI's compat mode, PARITY.md
    "Documented behavioral deviations")."""
    import jax

    from annonet_jax import serialization
    from annonet_jax.classes import (
        anno_classes_to_json,
        default_anno_classes,
    )
    from annonet_jax.models.segnet import (
        SegNetConfig,
        fold_batchnorm,
        init_state,
    )

    config = SegNetConfig(
        class_count=3, level_count=1, base_width=4,
        compute_dtype="float32",
    )
    params, bn = init_state(jax.random.PRNGKey(0), config)
    runtime = fold_batchnorm(params, bn, config)
    model_path = str(tmp_path / "annonet.dnn")
    serialization.save_model(
        model_path, runtime, config,
        anno_classes_to_json(default_anno_classes()), 1.0,
    )
    from annonet_jax.cli.serve import _ModelService, build_parser

    for flag, expected in (([], False),
                           (["--reference-blend-semantics"], True)):
        args = build_parser().parse_args(
            ["--model", model_path, "--port", "0",
             "--tile-max-width", "64", "--tile-max-height", "64", *flag]
        )
        service = _ModelService(args)
        assert service.inferer.reference_blend_semantics is expected
