"""The documented public embedding surface (docs/API.md).

Pins two things the rest of the suite reaches through deeper imports:
(1) every name in ``annonet_jax.__all__`` resolves from the top-level
package (the lazy ``__getattr__`` exports), and (2) the minimal embedding
program from docs/API.md §1-2 runs as written — the Python analog of the
reference's advertised embedding surface (annonet_infer.h:15-17).
"""

import numpy as np

import annonet_jax
from annonet_jax import (
    IGNORE_LABEL,
    SegNetConfig,
    TiledInferer,
    Trainer,
    TrainerConfig,
    annonet_infer,
    default_anno_classes,
    load_model,
    parse_anno_classes,
    save_model,
)
from annonet_jax.classes import anno_classes_to_json


def test_all_exports_resolve():
    for name in annonet_jax.__all__:
        assert getattr(annonet_jax, name) is not None, name
    # unknown attributes must raise AttributeError, not loop in __getattr__
    try:
        annonet_jax.no_such_symbol
    except AttributeError:
        pass
    else:
        raise AssertionError("expected AttributeError")


def test_documented_embedding_round_trip(tmp_path):
    """docs/API.md §2 (train + export) then §1 (load + infer), verbatim
    shapes: tiny model, one minibatch, save_model -> load_model ->
    TiledInferer -> annonet_infer with a gains sequence."""
    config = SegNetConfig(class_count=2, level_count=0, base_width=4)
    trainer = Trainer(config, TrainerConfig(initial_learning_rate=0.01))
    dim = 32
    images = np.random.default_rng(0).integers(
        0, 255, size=(2, dim, dim, 3), dtype=np.uint8
    )
    labels = np.zeros((2, dim, dim), np.uint16)
    labels[:, : dim // 2] = 1
    labels[0, 0, 0] = IGNORE_LABEL
    weights = np.ones((2, dim, dim), np.float32)
    weights[labels == IGNORE_LABEL] = 0.0
    loss = trainer.train_step(images, labels, weights)
    assert np.isfinite(loss)
    assert not trainer.should_stop

    classes_json = anno_classes_to_json(default_anno_classes()[:2])
    path = tmp_path / "annonet.dnn"
    save_model(str(path), trainer.runtime_net(), config, classes_json, 2.0)

    params, cfg, json_back, downscaling = load_model(str(path))
    assert cfg == config
    assert downscaling == 2.0
    assert parse_anno_classes(json_back) == default_anno_classes()[:2]

    inferer = TiledInferer(params, cfg)
    image = np.zeros((40, 56, 3), np.uint8)
    out = annonet_infer(inferer, image, gains=[0.0, -0.5])
    assert out.shape == (40, 56)
    assert out.dtype == np.uint16
    assert int(out.max()) < cfg.class_count
