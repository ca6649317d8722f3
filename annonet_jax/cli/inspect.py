"""annonet_inspect — describe a model artifact (and related files).

The ``annonet.dnn`` artifact is self-describing (class palette JSON +
downscaling factor + model config + BN-folded weights travel together,
matching the reference's serialized triple, annonet_train_main.cpp:557-565
/ annonet_infer_main.cpp:340-351). This tool prints that description as
JSON without loading any device backend — the offline analog of
``annonet_serve``'s GET /model — so deployment tooling can check what an
artifact IS before serving it:

    annonet_inspect annonet.dnn
    annonet_inspect annonet.dnn --weights-fingerprint   # also hash weights

Also understands persisted int8 calibration files
(``--calibration calib.npz``): prints their config/fingerprint pairing so
a stale-calibration reload failure can be diagnosed offline.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="annonet_inspect",
        description="Describe an annonet-jax model artifact as JSON.",
    )
    p.add_argument("model", help="Model artifact path (annonet.dnn)")
    p.add_argument("--weights-fingerprint", action="store_true",
                   help="Also compute the weights fingerprint "
                        "(serialization.weights_fingerprint) — the value "
                        "persisted int8 calibrations are checked against")
    p.add_argument("--calibration", default=None, metavar="PATH",
                   help="Also describe a persisted int8 calibration file "
                        "and report whether it matches this model")
    return p


def main(argv=None) -> int:
    from annonet_jax.cli.common import apply_platform_env

    apply_platform_env()  # consistency: every CLI pins the backend
    args = build_parser().parse_args(
        sys.argv[1:] if argv is None else argv
    )
    import numpy as np

    from annonet_jax import serialization
    from annonet_jax.classes import parse_anno_classes
    from annonet_jax.models.segnet import (
        recommended_input_dimension,
        required_input_dimension,
    )

    try:
        params, config, classes_json, downscaling = serialization.load_model(
            args.model
        )
    except Exception as e:  # noqa: BLE001
        print(json.dumps({"error": str(e), "model": args.model}))
        return 1
    anno_classes = parse_anno_classes(classes_json)

    flat = serialization.flatten_tree(params)
    info = {
        "model": args.model,
        "model_config": config.to_dict(),
        "downscaling_factor": downscaling,
        "required_input_dimension": required_input_dimension(config),
        "recommended_input_dimension": recommended_input_dimension(
            config, required_input_dimension(config)
        ),
        "classes": [
            {"index": c.index, "name": c.classlabel,
             "color_rgba": list(map(int, c.rgba_label))}
            for c in anno_classes
        ],
        "arrays": len(flat),
        "parameters": int(sum(int(np.prod(v.shape)) for v in flat.values())),
        "bytes": int(sum(v.nbytes for v in flat.values())),
    }
    if args.weights_fingerprint or args.calibration:
        info["weights_fingerprint"] = serialization.weights_fingerprint(
            params
        )
    if args.calibration:
        try:
            serialization.load_calibration(
                args.calibration, config, params
            )
            info["calibration"] = {
                "path": args.calibration, "matches_model": True,
            }
        except Exception as e:  # noqa: BLE001
            info["calibration"] = {
                "path": args.calibration, "matches_model": False,
                "error": str(e),
            }
    print(json.dumps(info, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
